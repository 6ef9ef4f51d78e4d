"""Measure the REFERENCE'S design on OUR hardware: normals-matrix streaming.

The reference's hot path (``/root/reference/src/spectralmc/gbm.py:224-257``
+ ``async_normals.py``) pregenerates a ``[timesteps, paths]`` cuRAND normals
matrix in device memory, then steps every path reading one row per timestep
— the whole matrix streams through device memory. Our kernel generates
normals in registers inside the time loop. This lab measures the SAME DESIGN
on the same card as our kernel:

  variant "reference_design"  — materialize normals in HBM, then scan rows
  variant "fused_xla"         — our XLA path (counter-keyed, no matrix)
  variant "fused_pallas"      — our production kernel (where it runs)

Run: python benchmarks/reference_design_lab.py
"""

from __future__ import annotations

import argparse
import functools
import statistics
import sys
import time
from pathlib import Path

# repo-root import without PYTHONPATH
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

CONTRACT = (100.0, 100.0, 1.0, 0.03, 0.01, 0.25)


@functools.partial(jax.jit, static_argnames=("timesteps", "paths"))
def reference_design(key: jax.Array, contract: jax.Array, *, timesteps: int, paths: int):
    """The reference's two-phase structure: full normals matrix, then step."""
    spot, _, maturity, rate, div_yield, vol = (contract[i] for i in range(6))
    dt = maturity / timesteps
    drift = (rate - div_yield - 0.5 * vol * vol) * dt
    vol_sdt = vol * jnp.sqrt(dt)
    # phase 1: the normals matrix lives in HBM (reference async_normals pool)
    normals = jax.random.normal(key, (timesteps, paths), jnp.float32)

    # phase 2: walk timesteps consuming one row each (reference kernel loop)
    def body(logx, z_row):
        return logx + drift + vol_sdt * z_row, None

    log0 = jnp.full((paths,), jnp.log(spot), jnp.float32)
    log_t, _ = jax.lax.scan(body, log0, normals)
    return jnp.exp(log_t)


def bench(fn, key, reps: int, work: int, calls: int = 5) -> float:
    """Units/s of ``reps`` calls scanned inside one jit: median of ``calls``
    timed calls ending in ``block_until_ready``, compilation excluded."""
    @jax.jit
    def run(k):
        def body(acc, i):
            out = fn(jax.random.fold_in(k, i))
            return acc + jnp.sum(out), None

        acc, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(reps))
        return acc

    jax.block_until_ready(run(key))
    times = []
    for c in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(run(jax.random.fold_in(key, c)))
        times.append(time.perf_counter() - t0)
    return work * reps / statistics.median(times)


def main() -> None:
    parser = argparse.ArgumentParser(description="HBM-normals reference design vs fused")
    parser.add_argument("--reps", type=int, default=300, help="scanned reps per call")
    parser.add_argument("--quick", action="store_true", help="smallest shape, fewest reps")
    args = parser.parse_args()
    from spectralmc_tpu.ops.gbm import PathScheme, simulate_terminal_rows
    from spectralmc_tpu.ops.gbm_pallas import pallas_supported, simulate_terminal_rows_pallas

    timesteps, rows, cols, reps = 64, 8192, 256, args.reps
    if args.quick:
        rows, reps = 1024, min(reps, 10)
    paths = rows * cols
    contract = jnp.array(CONTRACT, jnp.float32)
    key = jax.random.PRNGKey(0)
    work = paths * timesteps

    rate_ref = bench(
        lambda k: reference_design(k, contract, timesteps=timesteps, paths=paths),
        key, reps, work,
    )
    rate_xla = bench(
        lambda k: simulate_terminal_rows(
            k, contract, timesteps=timesteps, rows=rows, cols=cols,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
        ),
        key, reps, work,
    )
    if not pallas_supported(dtype=jnp.float32, rows=rows, cols=cols):
        print(f"reference_design (HBM normals matrix): {rate_ref:.3e} path-steps/s")
        print(f"fused_xla (counter-keyed, no matrix):  {rate_xla:.3e} path-steps/s")
        print("fused_pallas: the kernel does not run on this backend")
        return
    rate_pallas = bench(
        lambda k: simulate_terminal_rows_pallas(
            k, contract, timesteps=timesteps, rows=rows, cols=cols,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
        ),
        key, reps, work,
    )
    print(f"reference_design (HBM normals matrix): {rate_ref:.3e} path-steps/s")
    print(f"fused_xla (counter-keyed, no matrix):  {rate_xla:.3e} path-steps/s")
    print(f"fused_pallas (in-register threefry):   {rate_pallas:.3e} path-steps/s")
    print(f"pallas vs reference design, same card: {rate_pallas / rate_ref:.1f}x")


if __name__ == "__main__":
    main()
