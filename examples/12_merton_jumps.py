"""Example 12 — the Merton jump-diffusion family: train a CVNN on jumpy MC spectra.

The CVNN learns the characteristic function of discounted Merton put payoffs
over a 9-dimensional Sobol contract domain; Merton's exact series price (a
Poisson mixture of Black prices) grades the result. The per-step transition
is sampled exactly (no Euler bias), and pathwise Greeks flow through every
field except the documented fixed-count `lam` envelope.
Run: JAX_PLATFORMS=cpu python examples/12_merton_jumps.py
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
from spectralmc_tpu.ops.greeks import OptionSide, bump_greeks, mc_greeks
from spectralmc_tpu.ops.merton import MertonContract, merton_call_price
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
    "vol": BoundSpec(lower=0.15, upper=0.25),
    "lam": BoundSpec(lower=0.1, upper=0.8),
    "jump_mean": BoundSpec(lower=-0.15, upper=0.0),
    "jump_std": BoundSpec(lower=0.1, upper=0.25),
}


def main() -> None:
    sim = build_simulation_params(
        mc_seed=3, timesteps=8, network_size=32, batches_per_mc_run=64,
        model=ModelKind.MERTON_JUMP,
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
                 vol=0.2, lam=0.4, jump_mean=-0.08, jump_std=0.18)
    pred = pricer.predict_price([MertonContract(**probe)])
    _, put_exact = merton_call_price(**probe)
    err = (float(pred.put[0]) - put_exact) / put_exact
    print(f"model put={float(pred.put[0]):.4f}  series-exact={put_exact:.4f}  err={err:+.1%}")

    # MC Greeks: IPA is exact on the diffusion fields; the lam field needs
    # bump-and-reprice for the discrete count channel
    ipa = mc_greeks(sim, MertonContract(**probe), option=OptionSide.CALL)
    fd = bump_greeks(sim, MertonContract(**probe), option=OptionSide.CALL)
    print(f"delta: ipa={ipa.delta:+.4f} bump={fd.delta:+.4f}   "
          f"lam-greek: envelope={ipa.by_field['lam']:+.4f} full={fd.by_field['lam']:+.4f}")


if __name__ == "__main__":
    main()
