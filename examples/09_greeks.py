"""Example 9 — Greeks by autodiff: pathwise MC sensitivities + learned-pricer Jacobians.

Because the whole Monte-Carlo pipeline is a JAX program, every first-order
Greek (all six contract fields at once) is ONE reverse pass — something the
reference framework cannot do at all: its path kernel is Numba-JITted PTX,
invisible to torch autograd. Run: JAX_PLATFORMS=cpu python examples/09_greeks.py
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
from spectralmc_tpu.ops.gbm import BlackScholesContract, build_simulation_params
from spectralmc_tpu.ops.greeks import OptionSide, analytic_greeks, mc_greeks
from spectralmc_tpu.ops.sobol import BoundSpec
from spectralmc_tpu.training.trainer import GbmCVNNPricer, GbmCVNNPricerConfig


def main() -> None:
    contract = BlackScholesContract(
        spot=100.0, strike=105.0, maturity=1.0, rate=0.03, div_yield=0.01, vol=0.25
    )
    sim = build_simulation_params(
        timesteps=16, network_size=256, batches_per_mc_run=256, mc_seed=7
    ).expect("sim params")

    mc = mc_greeks(sim, contract, option=OptionSide.CALL)
    oracle = analytic_greeks(contract, option=OptionSide.CALL)

    print(f"{'greek':<12}{'pathwise MC':>14}{'Black-Scholes':>16}")
    for name in ("delta", "gamma", "vega", "theta", "rho", "dual_delta"):
        print(f"{name:<12}{getattr(mc, name):>14.5f}{getattr(oracle, name):>16.5f}")
    print(f"{'price':<12}{mc.price:>14.5f}{oracle.price:>16.5f}")

    # Greeks of the LEARNED pricer: smooth Jacobian over all fields + gamma.
    bounds = {
        "spot": BoundSpec(lower=80.0, upper=120.0),
        "strike": BoundSpec(lower=80.0, upper=120.0),
        "maturity": BoundSpec(lower=0.25, upper=2.0),
        "rate": BoundSpec(lower=0.0, upper=0.08),
        "div_yield": BoundSpec(lower=0.0, upper=0.04),
        "vol": BoundSpec(lower=0.15, upper=0.45),
    }
    cvnn = build_cvnn_config(
        layers=[LinearCfg(width=48, activation=Activation.MODRELU)], seed=3
    ).expect("cvnn config")
    tiny_sim = build_simulation_params(
        timesteps=4, network_size=32, batches_per_mc_run=8, mc_seed=7
    ).expect("sim params")
    pricer = GbmCVNNPricer.create(
        GbmCVNNPricerConfig(sim=tiny_sim, bounds=bounds, cvnn=cvnn)
    ).expect("pricer")
    from spectralmc_tpu.training.trainer import build_training_config

    pricer.train(
        build_training_config(num_batches=60, batch_size=16, learning_rate=3e-3).expect("cfg")
    ).expect("train")

    g = pricer.predict_greeks([contract])
    jac = dict(zip(g.fields, g.call_jacobian[0]))
    print("\nlearned pricer (after 60 online batches):")
    print(f"  call={g.call[0]:.4f}  delta={jac['spot']:.4f}  vega={jac['vol']:.4f}  "
          f"gamma={g.call_gamma[0]:.5f}")
    print("  (tighter after longer training — see docs/performance.md quality section)")


if __name__ == "__main__":
    main()
