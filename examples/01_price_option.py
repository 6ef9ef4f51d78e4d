"""Example 1 — Monte-Carlo option pricing with the GBM engine.

Parity: the reference's basic engine usage (README.md quick start).
Run: JAX_PLATFORMS=cpu python examples/01_price_option.py
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

from spectralmc_tpu.ops.analytic import black_scholes_price
from spectralmc_tpu.ops.gbm import BlackScholes, BlackScholesContract, build_simulation_params

params = build_simulation_params(
    timesteps=16, network_size=256, batches_per_mc_run=256, mc_seed=42
).expect("valid simulation params")
contract = BlackScholesContract(
    spot=100.0, strike=105.0, maturity=1.0, rate=0.03, div_yield=0.01, vol=0.25
)

engine = BlackScholes(params)
prices, engine = engine.price_to_host(contract)
analytic = black_scholes_price(
    contract.spot, contract.strike, contract.maturity,
    contract.rate, contract.div_yield, contract.vol,
)
print(f"MC put  = {prices.put:.4f}   analytic = {float(analytic.put):.4f}")
print(f"MC call = {prices.call:.4f}   analytic = {float(analytic.call):.4f}")
print(f"convexity (time value) = {prices.put_convexity:.4f}")
print(f"engine resume counter (skip) = {engine.params.skip}")
