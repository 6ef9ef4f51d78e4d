"""Example 13 — term structures: price and train against a curved market.

The desk's forward curve as config: bootstrap a piecewise-constant
``vol_shape`` from an implied-vol expiry strip (exactly reproducing every
quote, refusing calendar arbitrage), attach it with rising rates to
``SimulationParams.term``, and the unchanged MC → FFT → CVNN pipeline
prices the curved market — gated by the still-exact effective-Black oracle.
Run: JAX_PLATFORMS=cpu python examples/13_term_structures.py
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

from spectralmc_tpu.ops.analytic import black_scholes_price, term_effective_black
from spectralmc_tpu.ops.gbm import (
    BlackScholes,
    BlackScholesContract,
    TermStructure,
    bootstrap_vol_shape,
    build_simulation_params,
)
from spectralmc_tpu.ops.greeks import OptionSide, mc_greeks

TIMESTEPS = 8


def main() -> None:
    # 1. A market strip: near vols rich, far vols cheap (inverted curve),
    #    quoted at grid expiries. Bootstrap the forward-variance shape.
    quotes = ((2, 0.32), (5, 0.27), (8, 0.24))
    ref_vol = 0.25
    vol_shape = bootstrap_vol_shape(
        quotes, timesteps=TIMESTEPS, reference_vol=ref_vol
    ).expect("no calendar arbitrage in the strip")
    print("bootstrapped vol_shape:", [round(v, 4) for v in vol_shape])

    # a rising money-market curve: short rates at half the long rate
    term = TermStructure(
        vol_shape=vol_shape,
        rate_shape=tuple(0.5 + 1.0 * i / TIMESTEPS for i in range(TIMESTEPS)),
    )

    # 2. Monte-Carlo price under the curves vs the EXACT effective-Black
    #    oracle (the terminal law stays lognormal under piecewise curves).
    sim = build_simulation_params(
        timesteps=TIMESTEPS,
        network_size=256,
        batches_per_mc_run=256,
        mc_seed=11,
        term=term,
    ).expect("sim")
    contract = BlackScholesContract(
        spot=100.0, strike=102.0, maturity=1.0, rate=0.03, div_yield=0.01, vol=ref_vol
    )
    prices, _ = BlackScholes(sim).price_to_host(contract)
    oracle = term_effective_black(
        contract.spot, contract.strike, contract.maturity,
        contract.rate, contract.div_yield, contract.vol,
        vol_shape=term.vol_shape, rate_shape=term.rate_shape, div_shape=(),
    )
    flat = black_scholes_price(
        contract.spot, contract.strike, contract.maturity,
        contract.rate, contract.div_yield, contract.vol,
    )
    print(f"curved MC put      {prices.put:.4f}")
    print(f"effective-Black    {float(oracle.put):.4f}  (exact oracle)")
    print(f"flat Black         {float(flat.put):.4f}  (what ignoring the curve quotes)")

    # 3. Pathwise Greeks differentiate THROUGH the curves: vega picks up
    #    every step's vol * shape_t term.
    greeks = mc_greeks(sim, contract, option=OptionSide.PUT)
    print(
        f"curved greeks: delta {greeks.delta:.4f} vega {greeks.vega:.4f} "
        f"rho {greeks.by_field['rate']:.4f} (engine={greeks.engine.value})"
    )

    # 4. Early exercise under the same curves: LSMC discounts each monitor
    #    segment at its own curve rate; the lattice oracle
    #    (bermudan_grid_price) handles time-varying coefficients where a
    #    CRR tree cannot recombine.
    from spectralmc_tpu.ops.american import bermudan_grid_price

    asim = build_simulation_params(
        timesteps=TIMESTEPS,
        network_size=256,
        batches_per_mc_run=256,
        mc_seed=11,
        payoff="american_put",
        normalization="none",
        term=term,
    ).expect("asim")
    am_prices, _ = BlackScholes(asim).price_to_host(contract)
    am_oracle = bermudan_grid_price(
        spot=contract.spot, strike=contract.strike, maturity=contract.maturity,
        rate=contract.rate, div_yield=contract.div_yield, vol=contract.vol,
        timesteps=TIMESTEPS,
        vol_shape=term.vol_shape, rate_shape=term.rate_shape,
    )
    print(f"curved American put: LSMC {am_prices.put:.4f}  lattice {am_oracle:.4f}  "
          f"(European: {float(oracle.put):.4f})")


if __name__ == "__main__":
    main()
