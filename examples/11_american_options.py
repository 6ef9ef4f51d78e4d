"""Example 11 — American options: Longstaff-Schwartz in JAX.

Early exercise on the timestep grid as one backward lax.scan; the oracle is
a Bermudan-aware binomial tree restricted to the SAME exercise dates. Run:
JAX_PLATFORMS=cpu python examples/11_american_options.py
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

from spectralmc_tpu.ops.american import bermudan_tree_price, lsmc_price
from spectralmc_tpu.ops.analytic import black_scholes_price
from spectralmc_tpu.ops.gbm import BlackScholesContract
from spectralmc_tpu.ops.greeks import OptionSide


def main() -> None:
    contract = BlackScholesContract(
        spot=100.0, strike=110.0, maturity=1.0, rate=0.05, div_yield=0.0, vol=0.25
    )
    dates = 16
    result = lsmc_price(
        jax.random.PRNGKey(7), contract, timesteps=dates, paths=1 << 17,
        option=OptionSide.PUT,
    )
    tree = bermudan_tree_price(
        spot=contract.spot, strike=contract.strike, maturity=contract.maturity,
        rate=contract.rate, div_yield=contract.div_yield, vol=contract.vol,
        exercise_dates=dates, option="put",
    )
    euro = float(
        black_scholes_price(
            contract.spot, contract.strike, contract.maturity,
            contract.rate, contract.div_yield, contract.vol,
        ).put
    )
    print(f"American put (K=110, r=5%): LSMC {result.price:.4f} ± {result.std_error:.4f}")
    print(f"  Bermudan tree (same {dates} dates): {tree:.4f}")
    print(f"  European (Black):                  {euro:.4f}")
    print(f"  early-exercise premium:            {result.price - result.european:.4f}")

    # split-sample estimator: fit the exercise policy on half the paths,
    # price on the other half — the out-of-sample price is a statistical
    # lower bound (no look-ahead) and in_sample_price the classic high-biased
    # estimate, so the pair BRACKETS the true Bermudan price.
    bracket = lsmc_price(
        jax.random.PRNGKey(7), contract, timesteps=dates, paths=1 << 17,
        option=OptionSide.PUT, split_sample=True,
    )
    print(
        f"  split-sample bracket: [{bracket.price:.4f} (out-of-sample), "
        f"{bracket.in_sample_price:.4f} (in-sample)] ± {bracket.std_error:.4f}"
    )

    # ---- American as a FIRST-CLASS family (round 3): the same train →
    # predict → greeks pipeline every other family uses, via
    # payoff="american_put" (LSMC cashflows feed the learned spectrum).
    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
    from spectralmc_tpu.ops.gbm import build_simulation_params
    from spectralmc_tpu.ops.sobol import BoundSpec
    from spectralmc_tpu.training.trainer import (
        GbmCVNNPricer,
        GbmCVNNPricerConfig,
        build_training_config,
    )

    sim = build_simulation_params(
        timesteps=8, network_size=32, batches_per_mc_run=64, mc_seed=7,
        payoff="american_put", normalization="none",
    ).expect("sim")
    bounds = {
        "spot": BoundSpec(lower=95.0, upper=105.0),
        "strike": BoundSpec(lower=95.0, upper=105.0),
        "maturity": BoundSpec(lower=0.5, upper=1.5),
        "rate": BoundSpec(lower=0.01, upper=0.05),
        "div_yield": BoundSpec(lower=0.0, upper=0.02),
        "vol": BoundSpec(lower=0.2, upper=0.3),
    }
    cvnn = build_cvnn_config(
        layers=[
            LinearCfg(width=64, activation=Activation.MODRELU),
            LinearCfg(width=64, activation=Activation.ZRELU),
        ],
        seed=5,
    ).expect("cvnn")
    pricer = GbmCVNNPricer.create(
        GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=cvnn, normalize_inputs=True)
    ).expect("pricer")
    from spectralmc_tpu.training.step import LRScheduleConfig

    n_batches = 800
    tc = build_training_config(
        num_batches=n_batches, batch_size=32, learning_rate=2e-3,
        lr_schedule=LRScheduleConfig(
            peak=1.2e-2, warmup_steps=n_batches // 10, decay_steps=n_batches,
            end_value=1e-5,
        ),
    ).expect("tc")
    res = pricer.train(tc).expect("train")
    atm = BlackScholesContract(
        spot=100.0, strike=100.0, maturity=1.0, rate=0.04, div_yield=0.01, vol=0.25
    )
    pred = pricer.predict_price([atm])
    greeks = pricer.predict_greeks([atm])
    tree_atm = bermudan_tree_price(
        spot=atm.spot, strike=atm.strike, maturity=atm.maturity, rate=atm.rate,
        div_yield=atm.div_yield, vol=atm.vol, exercise_dates=8, option="put",
    )
    print(
        f"\nLearned American-put family ({n_batches} online batches, "
        f"loss {res.final_loss:.3g}):"
    )
    print(f"  predict_price ATM put: {float(pred.put[0]):.4f} (tree {tree_atm:.4f})")
    print(f"  delta of the learned surface: {float(greeks.put_jacobian[0, 0]):.4f}")
    print("  call channel is NaN: early exercise has no put-call parity")


if __name__ == "__main__":
    main()
