"""Path-dependent (Asian) payoff tests — extension beyond the reference.

The sharp gate: under the log-Euler scheme the discrete geometric-Asian MC
estimator has ZERO discretization bias against the closed form
(``ops/analytic.py::geometric_asian_price``), exactly like the Black formula
anchors TERMINAL payoffs in test_gbm.py. Arithmetic Asians are checked
against their analytic mean and put-call parity on the average.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectralmc_tpu.ops.analytic import geometric_asian_price
from spectralmc_tpu.ops.gbm import (
    BlackScholes,
    PathScheme,
    PayoffKind,
    build_simulation_params,
    expected_underlier_mean,
    simulate_underlier_rows,
)
from tests.helpers import expect_success
from tests.helpers.factories import make_contract

CONTRACT = make_contract(spot=100.0, strike=100.0, maturity=1.0, rate=0.03,
                         div_yield=0.01, vol=0.25)
TIMESTEPS = 8


def _underliers(payoff: PayoffKind, rows: int = 64, cols: int = 512) -> np.ndarray:
    key = jax.random.PRNGKey(11)
    arr = CONTRACT.as_array(jnp.float32)
    out = simulate_underlier_rows(
        key, arr, timesteps=TIMESTEPS, rows=rows, cols=cols,
        dtype=jnp.float32, scheme=PathScheme.LOG_EULER, payoff=payoff,
    )
    return np.asarray(out).reshape(-1)


def test_terminal_kind_is_bit_identical_to_terminal_rows() -> None:
    from spectralmc_tpu.ops.gbm import simulate_terminal_rows

    key = jax.random.PRNGKey(4)
    arr = CONTRACT.as_array(jnp.float32)
    kw = dict(timesteps=4, rows=8, cols=128, dtype=jnp.float32, scheme=PathScheme.LOG_EULER)
    a = np.asarray(simulate_terminal_rows(key, arr, **kw))
    b = np.asarray(simulate_underlier_rows(key, arr, payoff=PayoffKind.TERMINAL, **kw))
    assert np.array_equal(a, b)


@pytest.mark.parametrize("payoff", [PayoffKind.ASIAN_ARITHMETIC, PayoffKind.ASIAN_GEOMETRIC])
def test_average_mean_matches_analytic(payoff: PayoffKind) -> None:
    samples = _underliers(payoff)
    arr = CONTRACT.as_array(jnp.float64)
    target = float(
        expected_underlier_mean(arr, timesteps=TIMESTEPS, payoff=payoff, dtype=jnp.float64)
    )
    se = samples.std() / np.sqrt(samples.size)
    z = (samples.mean() - target) / se
    assert abs(z) < 4.0, f"mean {samples.mean():.4f} vs analytic {target:.4f}, z={z:.2f}"


def test_geometric_asian_price_matches_closed_form() -> None:
    """MC put price within 4 standard errors of the exact discrete closed form."""
    samples = _underliers(PayoffKind.ASIAN_GEOMETRIC, rows=128, cols=1024)
    df = np.exp(-CONTRACT.rate * CONTRACT.maturity)
    put_samples = df * np.maximum(CONTRACT.strike - samples, 0.0)
    mc_put = put_samples.mean()
    se = put_samples.std() / np.sqrt(put_samples.size)
    exact = geometric_asian_price(
        jnp.float64(CONTRACT.spot), jnp.float64(CONTRACT.strike),
        jnp.float64(CONTRACT.maturity), jnp.float64(CONTRACT.rate),
        jnp.float64(CONTRACT.div_yield), jnp.float64(CONTRACT.vol),
        timesteps=TIMESTEPS,
    )
    z = (mc_put - float(exact.put)) / se
    assert abs(z) < 4.0, f"MC {mc_put:.4f} vs exact {float(exact.put):.4f}, z={z:.2f}"
    # averaging strictly reduces optionality vs the European
    from spectralmc_tpu.ops.analytic import black_scholes_price

    euro = black_scholes_price(
        jnp.float64(CONTRACT.spot), jnp.float64(CONTRACT.strike),
        jnp.float64(CONTRACT.maturity), jnp.float64(CONTRACT.rate),
        jnp.float64(CONTRACT.div_yield), jnp.float64(CONTRACT.vol),
    )
    assert float(exact.put) < float(euro.put)


def test_engine_prices_asian_and_advances_skip() -> None:
    sim = expect_success(
        build_simulation_params(
            mc_seed=5, timesteps=TIMESTEPS, network_size=256, batches_per_mc_run=32,
            payoff=PayoffKind.ASIAN_GEOMETRIC,
        )
    )
    engine = BlackScholes(sim)
    host, advanced = engine.price_to_host(CONTRACT)
    exact = geometric_asian_price(
        jnp.float64(CONTRACT.spot), jnp.float64(CONTRACT.strike),
        jnp.float64(CONTRACT.maturity), jnp.float64(CONTRACT.rate),
        jnp.float64(CONTRACT.div_yield), jnp.float64(CONTRACT.vol),
        timesteps=TIMESTEPS,
    )
    assert abs(host.put - float(exact.put)) / float(exact.put) < 0.05
    assert advanced.params.skip == sim.skip + 1
    # put-call parity on the (normalized) average holds to fp tolerance
    target = float(expected_underlier_mean(
        CONTRACT.as_array(jnp.float64), timesteps=TIMESTEPS,
        payoff=PayoffKind.ASIAN_GEOMETRIC, dtype=jnp.float64,
    ))
    parity = host.call - host.put - host.discount_factor * (target - CONTRACT.strike)
    assert abs(parity) < 1e-2


def test_training_on_asian_payoff_converges_direction() -> None:
    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
    from spectralmc_tpu.training.trainer import (
        GbmCVNNPricer,
        GbmCVNNPricerConfig,
        build_training_config,
    )
    from tests.helpers.factories import CONTRACT_BOUNDS

    sim = expect_success(
        build_simulation_params(
            mc_seed=9, timesteps=4, network_size=32, batches_per_mc_run=8,
            payoff=PayoffKind.ASIAN_ARITHMETIC,
        )
    )
    cvnn = expect_success(
        build_cvnn_config(layers=[LinearCfg(width=24, activation=Activation.MODRELU)], seed=2)
    )
    pricer = expect_success(
        GbmCVNNPricer.create(GbmCVNNPricerConfig(sim=sim, bounds=CONTRACT_BOUNDS, cvnn=cvnn))
    )
    tc = expect_success(build_training_config(num_batches=30, batch_size=8, learning_rate=2e-3))
    result = expect_success(pricer.train(tc))
    assert np.all(np.isfinite(result.losses))
    assert result.losses[-5:].mean() < result.losses[:5].mean()


def test_pallas_asian_interpret_structure() -> None:
    """Zero-bit interpreter RNG -> deterministic skeleton for the Asian kernel."""
    from tests.helpers.kernels import zero_bits

    from spectralmc_tpu.ops.gbm_pallas import simulate_underlier_rows_pallas

    key = jax.random.PRNGKey(1)
    arr = CONTRACT.as_array(jnp.float32)
    with zero_bits():
        out = simulate_underlier_rows_pallas(
            key, arr, timesteps=4, rows=8, cols=128, dtype=jnp.float32,
            scheme=PathScheme.LOG_EULER, payoff=PayoffKind.ASIAN_GEOMETRIC,
            interpret=True,
        )
    t = np.asarray(out)
    assert t.shape == (8, 128)
    assert np.all(np.isfinite(t)) and np.all(t > 0)
    assert np.allclose(t, t[0, 0])  # zero-bit RNG -> identical paths
