"""Example 7 — the Heston model family: train a CVNN on stochastic-vol MC spectra.

The CVNN learns the characteristic function of discounted Heston put payoffs
over a 10-dimensional Sobol contract domain; the semi-analytic Heston price
(Fourier inversion of the model's own characteristic function) grades the
result. Run: JAX_PLATFORMS=cpu python examples/07_heston_pricer.py
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

from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
from spectralmc_tpu.ops.gbm import ModelKind, build_simulation_params
from spectralmc_tpu.ops.heston import HestonContract, heston_call_price
from spectralmc_tpu.ops.sobol import BoundSpec
from spectralmc_tpu.training.trainer import (
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    build_training_config,
)

BOUNDS = {
    "spot": BoundSpec(lower=95.0, upper=105.0),
    "strike": BoundSpec(lower=95.0, upper=105.0),
    "maturity": BoundSpec(lower=0.8, upper=1.2),
    "rate": BoundSpec(lower=0.02, upper=0.04),
    "div_yield": BoundSpec(lower=0.0, upper=0.02),
    "v0": BoundSpec(lower=0.03, upper=0.06),
    "kappa": BoundSpec(lower=1.0, upper=2.0),
    "theta": BoundSpec(lower=0.03, upper=0.06),
    "xi": BoundSpec(lower=0.2, upper=0.5),
    "rho": BoundSpec(lower=-0.8, upper=-0.4),
}


def main() -> None:
    sim = build_simulation_params(
        mc_seed=3, timesteps=8, network_size=32, batches_per_mc_run=64,
        model=ModelKind.HESTON,
    ).expect("sim")
    cvnn = build_cvnn_config(
        layers=[
            LinearCfg(width=64, activation=Activation.MODRELU),
            LinearCfg(width=64, activation=Activation.ZRELU),
        ],
        seed=5,
    ).expect("cvnn")
    pricer = GbmCVNNPricer.create(
        GbmCVNNPricerConfig(sim=sim, bounds=BOUNDS, cvnn=cvnn)
    ).expect("pricer")

    cfg = build_training_config(num_batches=600, batch_size=32, learning_rate=2e-3).expect("cfg")
    result = pricer.train(cfg).expect("train")
    print(f"loss: {result.losses[0]:.2f} -> {result.final_loss:.2f} "
          f"over {result.total_batches} batches")

    probe = dict(spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
                 v0=0.045, kappa=1.5, theta=0.045, xi=0.35, rho=-0.6)
    pred = pricer.predict_price([HestonContract(**probe)])
    _, put_exact = heston_call_price(**probe)
    err = (float(pred.put[0]) - put_exact) / put_exact
    print(f"model put={float(pred.put[0]):.4f}  semi-analytic={put_exact:.4f}  err={err:+.1%}")


if __name__ == "__main__":
    main()
