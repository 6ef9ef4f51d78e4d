"""MFU / roofline decomposition of the fused train step.

The train step's steps/s alone is unfalsifiable as good or bad, so this lab
decomposes the step at the two published shapes (bench and wide-spectrum)
into its two segments and states utilization for each:

* ``targets``  — Sobol draw → vmapped MC sim → per-contract FFT; the lab
  reports the segment's implied path-steps/s for direct comparison against
  the standalone kernel rate (chip_smoke.py's kernels phase).
* ``learn``    — CVNN forward/backward + Adam on precomputed targets; the lab
  reports achieved TFLOP/s and MFU against the device's peak at each matmul
  precision (utils/flops.py PEAK_MATMUL_FLOPS), under "default" and
  "highest" (the trainer's production pin, runtime/jax_runtime.py).

The reference publishes wall steps/s only (its harness times
``gbm_trainer.train()`` and nothing else).

Timing: reps scanned inside one jit, ``block_until_ready``, median of the
calls; compilation is not timed.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Callable

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from spectralmc_tpu.core.aliases import PyTree
from spectralmc_tpu.runtime.jax_runtime import matmul_precision_scope
from spectralmc_tpu.utils.flops import (
    PEAK_MATMUL_FLOPS,
    fft_flops,
    mfu,
    sim_path_steps,
    train_step_matmul_flops,
)


def scanned_carry_seconds(
    step: Callable[[PyTree, None], tuple[PyTree, jax.Array]],
    carry: PyTree,
    *,
    reps: int,
    calls: int,
) -> float:
    """Median wall seconds per rep of a carry-evolving step, ``reps``
    scanned inside one jit (the carry threads through every iteration, so
    none is loop-invariant)."""
    import statistics

    @jax.jit
    def run(c: PyTree) -> tuple[PyTree, jax.Array]:
        return jax.lax.scan(step, c, None, length=reps)

    carry = jax.block_until_ready(run(carry))[0]  # compile + warmup
    times = []
    for _ in range(calls):
        start = time.perf_counter()
        carry = jax.block_until_ready(run(carry))[0]
        times.append(time.perf_counter() - start)
    return statistics.median(times) / reps


def _lab_parser(description: str, *, default_reps: int) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--reps", type=int, default=default_reps, help="scanned reps per call")
    p.add_argument("--calls", type=int, default=3, help="timed calls (median kept)")
    p.add_argument("--quick", action="store_true", help="smallest shape, fewest reps")
    return p


def run_shape(
    name: str,
    *,
    timesteps: int,
    network: int,
    batches: int,
    batch_size: int,
    wide: bool,
    reps: int,
    calls: int,
) -> None:
    import __graft_entry__ as ge
    from spectralmc_tpu.ops.sobol import scale_to_bounds, sobol_unit
    from spectralmc_tpu.training.step import (
        make_fused_batch,
        make_mc_spectrum,
        make_optimizer,
    )

    # the production engine policy (bench.py main): the Pallas sim kernels
    # where they run, the XLA scan elsewhere — the decomposition must
    # measure the same program the published steps/s figures run
    from spectralmc_tpu.ops.gbm_pallas import pallas_supported

    kernels = pallas_supported(dtype=jnp.float32, rows=batches, cols=network)
    engine = "pallas" if kernels else "xla"
    model, sim, table, carry = ge._build(
        dict(timesteps=timesteps, network_size=network, batches_per_mc_run=batches,
             implementation=engine),
        wide=wide,
    )
    dtype = sim.precision.to_jnp()
    params = carry["params"]

    matmul = train_step_matmul_flops(params, batch_size)
    fft = fft_flops(batch_size, network)
    steps = sim_path_steps(batch_size, batches, network, timesteps)
    print(
        f"\n== {name}: T={timesteps} rows={batches} N={network} B={batch_size} "
        f"reps={reps} ==\n"
        f"per step: matmul {matmul / 1e6:.1f} MFLOP (fwd+bwd), "
        f"fft {fft / 1e6:.2f} MFLOP, sim {steps / 1e6:.1f} M path-steps",
        flush=True,
    )

    # -- full fused step ----------------------------------------------------
    full = make_fused_batch(model, sim, table, batch_size=batch_size, learning_rate=1e-3)

    def full_step(c: PyTree, _: None) -> tuple[PyTree, jax.Array]:
        c, (loss, _g) = full(c, None)
        return c, loss

    full_s = scanned_carry_seconds(full_step, dict(carry), reps=reps, calls=calls)

    # -- targets segment: Sobol -> MC -> FFT --------------------------------
    mc_spectrum = make_mc_spectrum(sim)
    lower = table.lower.astype(dtype)
    upper = table.upper.astype(dtype)

    def targets_step(c: PyTree, _: None) -> tuple[PyTree, jax.Array]:
        unit = sobol_unit(table.directions, table.shift, c["sobol_skip"], batch_size, dtype)
        contracts = scale_to_bounds(unit, lower, upper)
        draws = c["mc_skip"] + jnp.arange(batch_size, dtype=jnp.uint32)
        specs = jax.vmap(mc_spectrum)(draws, contracts)
        out = jnp.sum(jnp.abs(specs)).astype(jnp.float32)
        new = {
            "sobol_skip": c["sobol_skip"] + jnp.uint32(batch_size),
            "mc_skip": c["mc_skip"] + jnp.uint32(batch_size),
        }
        return new, out

    tgt_carry = {"sobol_skip": jnp.uint32(0), "mc_skip": jnp.uint32(0)}
    targets_s = scanned_carry_seconds(targets_step, tgt_carry, reps=reps, calls=calls)

    # -- learn segment: CVNN fwd/bwd + Adam on fixed targets ----------------
    unit0 = sobol_unit(table.directions, table.shift, jnp.uint32(0), batch_size, dtype)
    contracts0 = scale_to_bounds(unit0, lower, upper)
    draws0 = jnp.arange(batch_size, dtype=jnp.uint32)
    specs0 = jax.jit(jax.vmap(mc_spectrum))(draws0, contracts0)
    spec_re = specs0.real.astype(dtype)
    spec_im = specs0.imag.astype(dtype)
    optimizer = make_optimizer(1e-3)

    def make_learn_step() -> Callable[[PyTree, None], tuple[PyTree, jax.Array]]:
        import optax

        def learn_step(c: PyTree, _: None) -> tuple[PyTree, jax.Array]:
            def loss_fn(p: PyTree, s: PyTree) -> tuple[jax.Array, PyTree]:
                out_re, out_im, new_s = model.apply(
                    p, s, contracts0, jnp.zeros_like(contracts0), train=True
                )
                loss = jnp.mean(jnp.square(out_re - spec_re)) + jnp.mean(
                    jnp.square(out_im - spec_im)
                )
                return loss, new_s

            (loss, new_bn), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                c["params"], c["bn_state"]
            )
            updates, new_opt = optimizer.update(grads, c["opt_state"], c["params"])
            new = {
                "params": optax.apply_updates(c["params"], updates),
                "bn_state": new_bn,
                "opt_state": new_opt,
            }
            return new, loss.astype(jnp.float32)

        return learn_step

    learn_carry = {
        "params": params,
        "bn_state": carry["bn_state"],
        "opt_state": make_optimizer(1e-3).init(params),
    }
    learn_s: dict[str, float] = {}
    for precision in ("default", "highest"):
        with matmul_precision_scope(precision):
            learn_s[precision] = scanned_carry_seconds(
                make_learn_step(), dict(learn_carry), reps=reps, calls=calls
            )

    # -- report --------------------------------------------------------------
    sim_rate = steps / targets_s
    print(
        f"{'full step':>16s}: {full_s * 1e3:9.3f} ms  "
        f"({1.0 / full_s:,.0f} steps/s)",
        flush=True,
    )
    print(
        f"{'targets (MC+FFT)':>16s}: {targets_s * 1e3:9.3f} ms  "
        f"({targets_s / full_s:5.1%} of step; implied sim {sim_rate:.2e} "
        f"path-steps/s — compare the standalone kernel bench)",
        flush=True,
    )
    kind = jax.devices()[0].device_kind
    known = kind in PEAK_MATMUL_FLOPS
    # "default" lets float32 matmuls run in TF32 on the GPU; "highest" is
    # true float32
    peak_key = {"default": "tensorfloat32", "highest": "highest"}
    for precision in ("default", "highest"):
        if not known:
            print(f"{'learn (' + precision + ')':>16s}: {learn_s[precision] * 1e3:9.3f} ms  "
                  f"(no peak for device_kind={kind!r})", flush=True)
            continue
        tflops, frac = mfu(matmul, 1.0 / learn_s[precision], device_kind=kind,
                           precision=peak_key[precision])
        print(
            f"{'learn (' + precision + ')':>16s}: {learn_s[precision] * 1e3:9.3f} ms  "
            f"{tflops:7.2f} TFLOP/s = {frac:7.3%} MFU",
            flush=True,
        )
    resid = full_s - targets_s - learn_s["default"]
    print(
        f"{'accounting':>16s}: targets + learn(default) covers "
        f"{(targets_s + learn_s['default']) / full_s:5.1%} of the step "
        f"(residual {resid * 1e3:+.3f} ms = fusion/overhead delta)",
        flush=True,
    )
    if known:
        tflops_full, frac_full = mfu(matmul, 1.0 / full_s, device_kind=kind)
        print(f"{'step MFU':>16s}: {tflops_full:7.3f} TFLOP/s = {frac_full:7.4%} of "
              f"the float32 peak ({PEAK_MATMUL_FLOPS[kind]['highest'] / 1e12:.0f} TFLOP/s)",
              flush=True)


def main() -> None:
    p = _lab_parser(
        "Fused-train-step MFU/roofline decomposition", default_reps=0
    )
    args = p.parse_args()
    print(f"devices: {jax.devices()}", flush=True)
    if args.quick:
        run_shape(
            "quick", timesteps=4, network=32, batches=8, batch_size=8,
            wide=False, reps=args.reps or 20, calls=args.calls,
        )
        return
    run_shape(
        "bench", timesteps=16, network=128, batches=512, batch_size=64,
        wide=False, reps=args.reps or 1500, calls=args.calls,
    )
    run_shape(
        "wide", timesteps=16, network=2048, batches=16, batch_size=256,
        wide=True, reps=args.reps or 400, calls=args.calls,
    )


if __name__ == "__main__":
    main()
