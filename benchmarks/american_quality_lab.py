"""American quality decomposition lab (VERDICT r3 #7).

Splits the held-out American rel-MAE (BENCH `american_price_rel_mae`, the
weakest family gate at 0.90% in round 3) into its two components, which
have different fixes:

  LSMC policy bias — the Longstaff–Schwartz estimator itself (regression
      basis degree + per-draw path budget) vs the CRR Bermudan tree. The
      trainer's spectral targets come from PER-DRAW LSMC runs at the
      training sim shape (bench.py's quality config: 2048 paths x 16
      dates), so the thing the CVNN learns is E[LSMC price at 2048 paths]
      — including the small-sample regression bias of fitting a
      continuation surface on 2048 paths.
  CVNN fit error — whatever remains of the published rel-MAE after the
      policy bias is accounted for.

Method: for the SAME 64 held-out Sobol contracts the bench gate scores,
estimate E[LSMC price] by averaging many independent key draws per cell of
(basis_degree x per-draw paths), and report the rel-MAE of that mean vs
the tree. MC noise is driven below the bias scale by the rep count (the
per-cell SE is printed next to the bias so the split is honest).

Run on the card: `python benchmarks/american_quality_lab.py`.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

N_DATES = 16
N_HELDOUT = 64


def heldout_contracts() -> np.ndarray:
    """The bench gate's 64 held-out contracts (same bounds, same skip)."""
    from spectralmc_tpu.ops.sobol import (
        BoundSpec,
        SobolConfig,
        SobolSampler,
        scale_to_bounds,
        sobol_unit,
    )
    from spectralmc_tpu.ops.gbm import BlackScholesContract

    bounds = {
        "spot": BoundSpec(lower=95.0, upper=105.0),
        "strike": BoundSpec(lower=95.0, upper=105.0),
        "maturity": BoundSpec(lower=0.5, upper=1.5),
        "rate": BoundSpec(lower=0.01, upper=0.05),
        "div_yield": BoundSpec(lower=0.0, upper=0.02),
        "vol": BoundSpec(lower=0.2, upper=0.3),
    }
    sampler = SobolSampler.create(
        BlackScholesContract, bounds, SobolConfig(seed=7)
    ).expect("sampler")
    t = sampler.device_table()
    unit = sobol_unit(
        t["directions"], t["shift"], jnp.uint32(1 << 20), N_HELDOUT, jnp.float32
    )
    return np.asarray(scale_to_bounds(unit, t["lower"], t["upper"]), np.float64)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=16, help="independent seeds per contract")
    parser.add_argument("--quick", action="store_true", help="fewest reps only")
    args = parser.parse_args()
    from spectralmc_tpu.ops.american import (
        bermudan_tree_price,
        simulate_american_underlier_rows,
    )
    from spectralmc_tpu.ops.greeks import OptionSide

    grid = heldout_contracts()
    trees = np.array([
        bermudan_tree_price(
            spot=r[0], strike=r[1], maturity=r[2], rate=r[3], div_yield=r[4],
            vol=r[5], exercise_dates=N_DATES, option="put",
        )
        for r in grid
    ])

    # round-5 cells: the 8,192-path bench quality budget with the classic
    # in-sample policy vs the CROSS-FITTED policy (lsmc_cross_fit) — the
    # cross-fit rows measure what bias remains once look-ahead is gone
    # (expected: ~0, i.e. below the printed SE)
    cells = [
        (3, 2048, False), (5, 2048, False), (7, 2048, False),
        (5, 8192, False), (5, 8192, True),
        (5, 16384, False), (5, 131072, False),
    ]
    if args.quick:
        cells = [(5, 2048, False), (5, 8192, True)]
    reps = args.reps
    print(f"device: {jax.devices()[0].device_kind}; {N_HELDOUT} held-out "
          f"contracts x {reps} reps per cell; tree oracle at {N_DATES} dates")
    print("  deg   paths  xfit   E[LSMC] rel-MAE vs tree   mean per-contract SE(rel)")

    for deg, paths, xfit in cells:
        rows, cols = paths // 256, 256

        def one_price(key, carr, _deg=deg, _rows=rows, _cols=cols, _x=xfit):
            u = simulate_american_underlier_rows(
                key, carr, timesteps=N_DATES, rows=_rows, cols=_cols,
                dtype=jnp.float32, option=OptionSide.PUT, basis_degree=_deg,
                cross_fit=_x,
            )
            strike = carr[1]
            df = jnp.exp(-carr[3] * carr[2])
            return jnp.mean(df * jnp.maximum(strike - u, 0.0))

        @jax.jit
        def prices_for(carr):
            def body(_, i):
                return None, one_price(jax.random.fold_in(jax.random.PRNGKey(17), i), carr)

            _, p = jax.lax.scan(body, None, jnp.arange(reps))
            return p  # [reps]

        est = np.empty((N_HELDOUT, reps))
        for i, r in enumerate(grid):
            est[i] = np.asarray(prices_for(jnp.asarray(r, jnp.float32)))
        mean_p = est.mean(axis=1)
        se = est.std(axis=1, ddof=1) / np.sqrt(reps)
        rel_mae = float(np.mean(np.abs(mean_p - trees) / trees))
        rel_se = float(np.mean(se / trees))
        bias = float(np.mean((mean_p - trees) / trees))
        print(f"  {deg:>3} {paths:>7}  {str(xfit):>5}   {rel_mae:.4%} "
              f"(signed {bias:+.4%})       {rel_se:.4%}",
              flush=True)


if __name__ == "__main__":
    main()
