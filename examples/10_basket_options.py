"""Example 10 — multi-asset basket options: correlated GBMs.

Three correlated assets, options on the weighted basket. The geometric
basket is exactly lognormal under log-Euler, so its closed form grades the
MC; the correlation ablation shows the Cholesky mixing at work (basket calls
get pricier as assets co-move). Run: JAX_PLATFORMS=cpu python examples/10_basket_options.py
"""

# Make the repo importable when run straight from a checkout
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# Honor JAX_PLATFORMS even where an accelerator plugin overrides the env var
import os

if os.environ.get("JAX_PLATFORMS"):
    import jax

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import jax
import jax.numpy as jnp

from spectralmc_tpu.ops.analytic import geometric_basket_price
from spectralmc_tpu.ops.basket import (
    BasketCombine,
    build_basket_spec,
    expected_basket_underlier_mean,
    simulate_basket_underlier_rows,
)
from spectralmc_tpu.ops.gbm import BlackScholesContract, PayoffKind, terminal_to_prices
from spectralmc_tpu.ops.greeks import OptionSide, mc_greeks


def mc_call(spec, contract, *, rows=128, cols=2048, timesteps=6) -> float:
    arr = contract.as_array(jnp.float32)
    vals = simulate_basket_underlier_rows(
        jax.random.PRNGKey(7), arr, spec=spec, timesteps=timesteps, rows=rows,
        cols=cols, dtype=jnp.float32, payoff=PayoffKind.TERMINAL,
    )
    prices = terminal_to_prices(
        vals.reshape(-1), arr, normalize=True, dtype=jnp.float32,
        mean_target=expected_basket_underlier_mean(
            arr, spec, timesteps=timesteps, payoff=PayoffKind.TERMINAL, dtype=jnp.float32
        ),
    )
    return float(jnp.mean(prices.call_payoffs))


def main() -> None:
    contract = BlackScholesContract(
        spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01, vol=0.25
    )
    corr = ((1.0, 0.5, 0.2), (0.5, 1.0, 0.3), (0.2, 0.3, 1.0))

    geo = build_basket_spec(
        weights=(0.5, 0.3, 0.2), correlation=corr,
        spot_multipliers=(1.0, 0.9, 1.1), vol_multipliers=(1.0, 1.3, 0.7),
        combine=BasketCombine.GEOMETRIC,
    ).expect("spec")
    analytic = geometric_basket_price(
        contract.spot, contract.strike, contract.maturity, contract.rate,
        contract.div_yield, contract.vol, spec=geo,
    )
    print(f"geometric basket call: MC {mc_call(geo, contract):.4f}  "
          f"closed form {float(analytic.call):.4f}")

    print("\narithmetic basket call vs correlation (co-movement => variance => value):")
    for rho in (0.0, 0.4, 0.8):
        spec = build_basket_spec(
            weights=(1 / 3, 1 / 3, 1 / 3),
            correlation=tuple(tuple(1.0 if i == j else rho for j in range(3)) for i in range(3)),
        ).expect("spec")
        print(f"  rho={rho:.1f}: {mc_call(spec, contract):.4f}")

    from spectralmc_tpu.ops.gbm import ModelKind, build_simulation_params

    sim = build_simulation_params(
        timesteps=6, network_size=256, batches_per_mc_run=256, mc_seed=7,
        model=ModelKind.BASKET_GBM, basket=geo,
    ).expect("sim")
    g = mc_greeks(sim, contract, option=OptionSide.CALL)
    print(f"\npathwise basket greeks: delta={g.delta:.4f} vega={g.vega:.4f} "
          f"rho={g.rho:.4f} theta={g.theta:.4f}")


if __name__ == "__main__":
    main()
