"""Antithetic variates (variance reduction; no reference counterpart).

Core identity under log-Euler: with pairing row r ↔ r+H, the log-paths
satisfy ln S[r+H](t) + ln S[r](t) = 2(ln S0 + t·drift) EXACTLY (the normals
cancel) — tested bit-tight. Unbiasedness via the analytic z-gate, variance
reduction measured over repeated draws, shard stability across the pair
boundary, engine config plumbing, and wire-format round trip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectralmc_tpu.core.errors.gbm import InvalidSimulationParams
from spectralmc_tpu.ops.analytic import black_scholes_price
from spectralmc_tpu.ops.gbm import (
    PathScheme,
    PayoffKind,
    build_simulation_params,
    expected_underlier_mean,
    simulate_terminal_rows,
    simulate_underlier_rows,
    terminal_to_prices,
)
from tests.helpers.factories import make_contract, make_simulation_params
from tests.helpers.result_utils import expect_failure, expect_success


def test_antithetic_requires_even_rows() -> None:
    bad = build_simulation_params(
        timesteps=2, network_size=8, batches_per_mc_run=3, mc_seed=1, antithetic=True
    )
    assert isinstance(expect_failure(bad), InvalidSimulationParams)
    ok = build_simulation_params(
        timesteps=2, network_size=8, batches_per_mc_run=4, mc_seed=1, antithetic=True
    )
    assert expect_success(ok).antithetic


def test_mirror_identity_log_euler_exact() -> None:
    """ln S[r+H] + ln S[r] == 2(ln S0 + n*drift) bit-tight: the pairs use the
    SAME normals negated, so the stochastic part cancels exactly."""
    c = make_contract()
    arr = c.as_array(jnp.float32)
    rows, n = 8, 6
    t = simulate_terminal_rows(
        jax.random.PRNGKey(3), arr, timesteps=n, rows=rows, cols=64,
        dtype=jnp.float32, scheme=PathScheme.LOG_EULER, antithetic_half=rows // 2,
    )
    log_t = np.log(np.asarray(t, dtype=np.float64))
    dt = c.maturity / n
    drift = (c.rate - c.div_yield - 0.5 * c.vol**2) * dt
    expected_sum = 2.0 * (np.log(c.spot) + n * drift)
    sums = log_t[: rows // 2] + log_t[rows // 2 :]
    np.testing.assert_allclose(sums, expected_sum, rtol=2e-5)
    # first half reproduces the plain (non-antithetic) rows to ~1 ulp — the
    # sign multiply changes XLA's fusion pattern, so exact bit equality holds
    # only WITHIN a config (resume/shard contract), not across configs
    plain = simulate_terminal_rows(
        jax.random.PRNGKey(3), arr, timesteps=n, rows=rows // 2, cols=64,
        dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
    )
    np.testing.assert_allclose(
        np.asarray(t[: rows // 2]), np.asarray(plain), rtol=3e-6
    )


def test_antithetic_unbiased_vs_black_scholes() -> None:
    c = make_contract()
    arr = c.as_array(jnp.float32)
    t = simulate_terminal_rows(
        jax.random.PRNGKey(7), arr, timesteps=8, rows=128, cols=1024,
        dtype=jnp.float32, scheme=PathScheme.LOG_EULER, antithetic_half=64,
    )
    prices = terminal_to_prices(
        t.reshape(-1), arr, normalize=True, dtype=jnp.float32,
        mean_target=expected_underlier_mean(
            arr, timesteps=8, payoff=PayoffKind.TERMINAL, dtype=jnp.float32
        ),
    )
    analytic = black_scholes_price(c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol)
    mc = float(jnp.mean(prices.call_payoffs))
    # pairwise means are the iid units for the standard error
    pair_means = (
        np.asarray(prices.call_payoffs).reshape(128, 1024)[:64]
        + np.asarray(prices.call_payoffs).reshape(128, 1024)[64:]
    ) / 2.0
    se = pair_means.std() / np.sqrt(pair_means.size)
    z = abs(mc - float(analytic.call)) / se
    assert z < 4.0, f"z={z}: mc={mc} analytic={float(analytic.call)}"


def test_variance_reduction_measured() -> None:
    """Same total path budget: the antithetic estimator's across-draw
    variance must come in well under the independent one's (a call payoff is
    monotone in the terminal value, so reduction is guaranteed)."""
    c = make_contract()
    arr = c.as_array(jnp.float32)

    def estimate(draw: int, half: int | None) -> float:
        t = simulate_terminal_rows(
            jax.random.fold_in(jax.random.PRNGKey(123), draw), arr,
            timesteps=4, rows=16, cols=256, dtype=jnp.float32,
            scheme=PathScheme.LOG_EULER, antithetic_half=half,
        )
        prices = terminal_to_prices(t.reshape(-1), arr, normalize=False, dtype=jnp.float32)
        return float(jnp.mean(prices.call_payoffs))

    indep = np.array([estimate(d, None) for d in range(30)])
    anti = np.array([estimate(d, 8) for d in range(30)])
    assert anti.var() < 0.6 * indep.var(), (anti.var(), indep.var())
    # and unbiased relative to each other
    assert abs(anti.mean() - indep.mean()) < 4 * indep.std() / np.sqrt(30)


def test_shard_stability_across_pair_boundary() -> None:
    """A shard owning rows [k, k+n) reproduces the full antithetic run even
    when its rows are all mirror rows (pair partner on another shard)."""
    c = make_contract()
    arr = c.as_array(jnp.float32)
    key = jax.random.PRNGKey(5)
    kwargs = dict(
        timesteps=3, cols=128, dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
        payoff=PayoffKind.ASIAN_ARITHMETIC, antithetic_half=4,
    )
    full = simulate_underlier_rows(key, arr, rows=8, **kwargs)
    mirror_shard = simulate_underlier_rows(key, arr, rows=4, row_offset=4, **kwargs)
    np.testing.assert_array_equal(np.asarray(full[4:]), np.asarray(mirror_shard))


def test_heston_and_basket_mirror_identity() -> None:
    """Negating the full Gaussian driver mirrors the log-path exactly in the
    DRIVERS; for Heston the variance path is NOT mirrored (v feeds back), so
    we check: first half ~= plain run (1-ulp class; see the fusion note in
    test_mirror_identity_log_euler_exact)."""
    from spectralmc_tpu.ops.basket import build_basket_spec, simulate_basket_underlier_rows
    from spectralmc_tpu.ops.heston import HestonContract, simulate_heston_underlier_rows

    hc = HestonContract(
        spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
        v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.7,
    )
    key = jax.random.PRNGKey(11)
    kwargs = dict(timesteps=4, cols=128, dtype=jnp.float32, payoff=PayoffKind.TERMINAL)
    anti = simulate_heston_underlier_rows(
        key, hc.as_array(jnp.float32), rows=8, antithetic_half=4, **kwargs
    )
    plain = simulate_heston_underlier_rows(key, hc.as_array(jnp.float32), rows=4, **kwargs)
    np.testing.assert_allclose(np.asarray(anti[:4]), np.asarray(plain), rtol=3e-6)
    assert np.isfinite(np.asarray(anti)).all()

    spec = expect_success(
        build_basket_spec(weights=(0.6, 0.4), correlation=((1.0, 0.4), (0.4, 1.0)))
    )
    bc = make_contract()
    banti = simulate_basket_underlier_rows(
        key, bc.as_array(jnp.float32), spec=spec, rows=8, antithetic_half=4, **kwargs
    )
    bplain = simulate_basket_underlier_rows(
        key, bc.as_array(jnp.float32), spec=spec, rows=4, **kwargs
    )
    np.testing.assert_allclose(np.asarray(banti[:4]), np.asarray(bplain), rtol=3e-6)
    # geometric-combine log-mirror: ln B[r+H] + ln B[r] is deterministic
    gspec = expect_success(
        build_basket_spec(
            weights=(0.6, 0.4), correlation=((1.0, 0.4), (0.4, 1.0)), combine="geometric"
        )
    )
    g = simulate_basket_underlier_rows(
        key, bc.as_array(jnp.float32), spec=gspec, rows=8, antithetic_half=4, **kwargs
    )
    glog = np.log(np.asarray(g, dtype=np.float64))
    sums = glog[:4] + glog[4:]
    np.testing.assert_allclose(sums, sums[0, 0], rtol=2e-5)


def test_pallas_in_block_mirror_interpret_mode() -> None:
    """Interpret mode (zero-bit stream): antithetic partners are the global
    row pairs (2k, 2k+1), so odd rows negate the deterministic z and their
    log equals 2(lnS0 + drift·n) − the even partner's log — checkable in
    closed form like the other interpret tests."""
    from spectralmc_tpu.ops.gbm_pallas import simulate_terminal_rows_pallas
    from tests.helpers.kernels import zero_bits

    c = make_contract()
    arr = c.as_array(jnp.float32)
    n = 4
    with zero_bits():
        t = simulate_terminal_rows_pallas(
            jax.random.PRNGKey(1), arr, timesteps=n, rows=8, cols=128,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
            antithetic_half=4, interpret=True,
        )
    log_t = np.log(np.asarray(t, dtype=np.float64))
    dt = c.maturity / n
    drift = (c.rate - c.div_yield - 0.5 * c.vol**2) * dt
    np.testing.assert_allclose(
        log_t[0::2] + log_t[1::2], 2.0 * (np.log(c.spot) + n * drift), rtol=2e-5
    )


def test_antithetic_proto_round_trip_and_trainer() -> None:
    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
    from spectralmc_tpu.serialization.converters import (
        sim_params_from_proto,
        sim_params_to_proto,
    )
    from spectralmc_tpu.training.trainer import (
        GbmCVNNPricer,
        GbmCVNNPricerConfig,
        build_training_config,
    )
    from tests.helpers.factories import CONTRACT_BOUNDS

    sim = make_simulation_params(
        timesteps=2, network_size=16, batches_per_mc_run=4, antithetic=True
    )
    assert expect_success(sim_params_from_proto(sim_params_to_proto(sim))).antithetic

    cvnn = expect_success(
        build_cvnn_config(layers=[LinearCfg(width=24, activation=Activation.MODRELU)], seed=3)
    )
    pricer = expect_success(
        GbmCVNNPricer.create(GbmCVNNPricerConfig(sim=sim, bounds=CONTRACT_BOUNDS, cvnn=cvnn))
    )
    tc = expect_success(build_training_config(num_batches=15, batch_size=8, learning_rate=3e-3))
    result = expect_success(pricer.train(tc))
    assert float(np.mean(result.losses[-5:])) < float(np.mean(result.losses[:5]))
    resumed = expect_success(GbmCVNNPricer.create(pricer.snapshot()))
    tc5 = expect_success(build_training_config(num_batches=5, batch_size=8, learning_rate=3e-3))
    np.testing.assert_array_equal(
        expect_success(pricer.train(tc5)).losses,
        expect_success(resumed.train(tc5)).losses,
    )


def test_greeks_flow_through_antithetic() -> None:
    from spectralmc_tpu.ops.greeks import OptionSide, analytic_greeks, mc_greeks

    sim = make_simulation_params(
        timesteps=8, network_size=256, batches_per_mc_run=256, antithetic=True
    )
    contract = make_contract()
    mc = mc_greeks(sim, contract, option=OptionSide.CALL)
    oracle = analytic_greeks(contract, option=OptionSide.CALL)
    assert mc.delta == pytest.approx(oracle.delta, rel=0.03, abs=0.004)
    assert mc.vega == pytest.approx(oracle.vega, rel=0.03)


def test_blackscholes_engine_honors_antithetic() -> None:
    """Regression: the direct BlackScholes engine used to drop the flag.
    Its terminal stream must equal simulate_underlier_rows with the global
    pairing half — the same bits every other driver produces."""
    from spectralmc_tpu.ops.gbm import BlackScholes

    sim = make_simulation_params(
        timesteps=3, network_size=64, batches_per_mc_run=8, antithetic=True
    )
    engine = BlackScholes(sim)
    c = make_contract()
    got = engine.simulate_terminal(c.as_array(jnp.float32), sim.skip)
    want = simulate_underlier_rows(
        engine.contract_key(sim.skip), c.as_array(jnp.float32),
        timesteps=3, rows=8, cols=64, dtype=jnp.float32,
        scheme=PathScheme.LOG_EULER, payoff=PayoffKind.TERMINAL,
        antithetic_half=4,
    ).reshape(-1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
