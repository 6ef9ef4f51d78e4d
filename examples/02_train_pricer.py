"""Example 2 — train a CVNN pricer on MC spectra (the core workflow).

Parity: reference examples/checkpoint_training-style flow.
Run: JAX_PLATFORMS=cpu python examples/02_train_pricer.py
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

import numpy as np

from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
from spectralmc_tpu.ops.analytic import black_scholes_price
from spectralmc_tpu.ops.gbm import BlackScholesContract, build_simulation_params
from spectralmc_tpu.ops.sobol import BoundSpec
from spectralmc_tpu.training import GbmCVNNPricer, GbmCVNNPricerConfig, build_training_config

bounds = {
    "spot": BoundSpec(lower=95.0, upper=105.0),
    "strike": BoundSpec(lower=95.0, upper=105.0),
    "maturity": BoundSpec(lower=0.9, upper=1.1),
    "rate": BoundSpec(lower=0.02, upper=0.04),
    "div_yield": BoundSpec(lower=0.005, upper=0.015),
    "vol": BoundSpec(lower=0.2, upper=0.3),
}
sim = build_simulation_params(
    timesteps=2, network_size=32, batches_per_mc_run=64, mc_seed=5
).expect("sim")
cvnn = build_cvnn_config(
    layers=[
        LinearCfg(width=64, activation=Activation.MODRELU),
        LinearCfg(width=64, activation=Activation.MODRELU),
    ],
    seed=3,
).expect("cvnn")

pricer = GbmCVNNPricer.create(
    GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=cvnn)
).expect("pricer")
result = pricer.train(
    build_training_config(num_batches=600, batch_size=32, learning_rate=2e-3).expect("cfg")
).expect("training")
print(f"loss: {np.mean(result.losses[:10]):.2f} -> {np.mean(result.losses[-10:]):.2f}")

contracts = [
    BlackScholesContract(spot=100, strike=k, maturity=1.0, rate=0.03, div_yield=0.01, vol=0.25)
    for k in (96.0, 100.0, 104.0)
]
pred = pricer.predict_price(contracts)
for c, put in zip(contracts, pred.put):
    a = float(black_scholes_price(c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol).put)
    print(f"K={c.strike}: model put={put:.3f}  analytic={a:.3f}  err={(put - a) / a:+.1%}")
