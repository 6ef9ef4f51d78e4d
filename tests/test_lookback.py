"""Lookback payoffs (fixed + floating strike) across dynamics, both engines.

Oracle: ``ops/analytic.py::lookback_price`` — the running-extreme
distribution recovered by barrier-survival integration with the simulator's
exact discrete monitoring (t_0..t_N, t_0 included), so the gates carry no
monitoring-correction slop. The geometric basket maps to an EXACT
single-asset oracle (ln B is itself a GBM). Structural gates: the pathwise
sandwich m ≤ S_T ≤ M on the shared bit stream, floating payoffs certain
(call channel identically zero), and deterministic zero-bit Pallas replays.
IPA Greeks are VALID for lookbacks (running extremes are a.e.
differentiable) — gated against finite differences of the oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectralmc_tpu.core.errors.gbm import InvalidSimulationParams
from spectralmc_tpu.ops.analytic import lookback_price
from spectralmc_tpu.ops.gbm import (
    LOOKBACK_MAX_PAYOFFS,
    LOOKBACK_PAYOFFS,
    ForwardNormalization,
    ModelKind,
    PathScheme,
    PayoffKind,
    build_simulation_params,
    expected_underlier_mean,
    has_closed_form_mean,
    simulate_terminal_rows,
    simulate_underlier_rows,
    terminal_to_prices,
)
from tests.helpers.factories import make_contract, make_simulation_params
from tests.helpers.result_utils import expect_failure, expect_success

ALL_KINDS = sorted(LOOKBACK_PAYOFFS, key=lambda p: p.value)


def _oracle_field(payoff: PayoffKind) -> str:
    return {
        PayoffKind.LOOKBACK_FIXED_CALL: "fixed_call",
        PayoffKind.LOOKBACK_FIXED_PUT: "fixed_put",
        PayoffKind.LOOKBACK_FLOAT_CALL: "float_call",
        PayoffKind.LOOKBACK_FLOAT_PUT: "float_put",
    }[payoff]


def test_lookback_config_validation() -> None:
    common = dict(timesteps=2, network_size=8, batches_per_mc_run=2, mc_seed=1)
    mean_norm = build_simulation_params(
        **common,
        payoff=PayoffKind.LOOKBACK_FIXED_CALL,
        normalization=ForwardNormalization.MEAN,
    )
    assert isinstance(expect_failure(mean_norm), InvalidSimulationParams)
    stray = build_simulation_params(
        **common, payoff=PayoffKind.LOOKBACK_FIXED_PUT, barrier_rel=1.5
    )
    assert isinstance(expect_failure(stray), InvalidSimulationParams)
    ok = expect_success(
        build_simulation_params(
            **common,
            payoff=PayoffKind.LOOKBACK_FLOAT_PUT,
            normalization=ForwardNormalization.NONE,
        )
    )
    assert ok.payoff == PayoffKind.LOOKBACK_FLOAT_PUT


def test_lookback_no_closed_form_mean() -> None:
    from spectralmc_tpu.ops.basket import (
        BasketCombine,
        BasketSpec,
        expected_basket_underlier_mean,
    )

    spec = BasketSpec(
        weights=(0.6, 0.4), spot_multipliers=(1.0, 1.0), vol_multipliers=(1.0, 1.0),
        correlation=((1.0, 0.3), (0.3, 1.0)), combine=BasketCombine.GEOMETRIC,
    )
    for payoff in ALL_KINDS:
        assert not has_closed_form_mean(ModelKind.GBM, payoff)
        assert (
            expected_underlier_mean(
                make_contract().as_array(jnp.float32),
                timesteps=4, payoff=payoff, dtype=jnp.float32,
            )
            is None
        )
        assert (
            expected_basket_underlier_mean(
                make_contract().as_array(jnp.float32), spec,
                timesteps=4, payoff=payoff, dtype=jnp.float32,
            )
            is None
        )


def _mc_put_channel(payoff, *, timesteps=6, rows=128, cols=1024, key=11,
                    scheme=PathScheme.LOG_EULER, contract=None, **sim_kwargs):
    contract = contract or make_contract(strike=105.0)
    arr = contract.as_array(jnp.float32)
    u = simulate_underlier_rows(
        jax.random.PRNGKey(key), arr, timesteps=timesteps, rows=rows, cols=cols,
        dtype=jnp.float32, scheme=scheme, payoff=payoff, **sim_kwargs,
    )
    prices = terminal_to_prices(u.reshape(-1), arr, normalize=False, dtype=jnp.float32)
    mc = float(jnp.mean(prices.put_payoffs))
    se = float(jnp.std(prices.put_payoffs)) / np.sqrt(prices.put_payoffs.size)
    return mc, se, prices


@pytest.mark.parametrize("payoff", ALL_KINDS, ids=lambda p: p.value)
def test_gbm_lookback_matches_survival_oracle(payoff: PayoffKind) -> None:
    c = make_contract(strike=105.0)
    mc, se, prices = _mc_put_channel(payoff, contract=c)
    lb = lookback_price(
        c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol, timesteps=6
    )
    want = getattr(lb, _oracle_field(payoff))
    z = abs(mc - want) / se
    assert z < 4.0, f"{payoff.value}: z={z} mc={mc} oracle={want}"
    if payoff in (PayoffKind.LOOKBACK_FLOAT_CALL, PayoffKind.LOOKBACK_FLOAT_PUT):
        # floating payoffs are certain: the opposite channel is exactly zero
        assert float(prices.call_payoffs.max()) == 0.0


def test_gbm_lookback_term_structure_matches_oracle() -> None:
    from spectralmc_tpu.ops.gbm import TermStructure

    term = TermStructure(
        vol_shape=(1.3, 1.0, 0.8, 0.9), rate_shape=(1.2, 1.0, 0.9, 0.9),
        div_shape=(1.0, 1.1, 1.0, 0.9),
    )
    c = make_contract(strike=102.0)
    mc, se, _ = _mc_put_channel(
        PayoffKind.LOOKBACK_FIXED_CALL, timesteps=4, rows=256, contract=c, term=term
    )
    lb = lookback_price(
        c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol, timesteps=4,
        vol_shape=term.vol_shape, rate_shape=term.rate_shape, div_shape=term.div_shape,
    )
    z = abs(mc - lb.fixed_call) / se
    assert z < 4.0, f"term fixed_call: z={z} mc={mc} oracle={lb.fixed_call}"


@pytest.mark.parametrize("scheme", [PathScheme.LOG_EULER, PathScheme.EULER])
def test_lookback_pathwise_sandwich(scheme: PathScheme) -> None:
    """On the shared bit stream: m ≤ S_T ≤ M per path, for both schemes."""
    c = make_contract(strike=104.0)
    arr = c.as_array(jnp.float32)
    kwargs = dict(timesteps=6, rows=8, cols=128, dtype=jnp.float32, scheme=scheme)
    term = np.asarray(simulate_terminal_rows(jax.random.PRNGKey(3), arr, **kwargs))
    u_min = np.asarray(
        simulate_underlier_rows(
            jax.random.PRNGKey(3), arr, payoff=PayoffKind.LOOKBACK_FIXED_PUT, **kwargs
        )
    )
    u_max_enc = np.asarray(
        simulate_underlier_rows(
            jax.random.PRNGKey(3), arr, payoff=PayoffKind.LOOKBACK_FIXED_CALL, **kwargs
        )
    )
    running_max = 2.0 * np.float32(c.strike) - u_max_enc  # invert the reflection
    tol = 1e-3  # exp(ext) vs exp(logx) rounding in f32
    assert (u_min <= term + tol).all()
    assert (running_max >= term - tol).all()
    assert (u_min <= c.spot + tol).all() and (running_max >= c.spot - tol).all()


def test_heston_lookback_structural() -> None:
    from spectralmc_tpu.ops.heston import HestonContract, simulate_heston_underlier_rows

    c = HestonContract(
        spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.0,
        v0=0.04, kappa=1.5, theta=0.04, xi=0.4, rho=-0.6,
    )
    arr = c.as_array(jnp.float32)
    kwargs = dict(timesteps=6, rows=32, cols=256, dtype=jnp.float32)
    term = np.asarray(
        simulate_heston_underlier_rows(
            jax.random.PRNGKey(7), arr, payoff=PayoffKind.TERMINAL, **kwargs
        )
    )
    u_min = np.asarray(
        simulate_heston_underlier_rows(
            jax.random.PRNGKey(7), arr, payoff=PayoffKind.LOOKBACK_FIXED_PUT, **kwargs
        )
    )
    u_fp = np.asarray(
        simulate_heston_underlier_rows(
            jax.random.PRNGKey(7), arr, payoff=PayoffKind.LOOKBACK_FLOAT_PUT, **kwargs
        )
    )
    assert (u_min <= term + 1e-3).all()
    # float put underlier u = K − (M − S_T) ≤ K (payoff nonnegative)
    assert (u_fp <= c.strike + 1e-3).all()


def test_merton_lookback_structural() -> None:
    from spectralmc_tpu.ops.merton import MertonContract, simulate_merton_underlier_rows

    c = MertonContract(
        spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
        vol=0.2, lam=1.0, jump_mean=-0.1, jump_std=0.2,
    )
    arr = c.as_array(jnp.float32)
    kwargs = dict(timesteps=6, rows=32, cols=256, dtype=jnp.float32)
    term = np.asarray(
        simulate_merton_underlier_rows(
            jax.random.PRNGKey(5), arr, payoff=PayoffKind.TERMINAL, **kwargs
        )
    )
    u_max_enc = np.asarray(
        simulate_merton_underlier_rows(
            jax.random.PRNGKey(5), arr, payoff=PayoffKind.LOOKBACK_FIXED_CALL, **kwargs
        )
    )
    running_max = 2.0 * np.float32(c.strike) - u_max_enc
    assert (running_max >= term - 1e-3).all()
    assert (running_max >= c.spot - 1e-3).all()


def test_basket_geometric_lookback_matches_effective_gbm_oracle() -> None:
    """ln B is itself a GBM, so the single-asset survival oracle at the
    effective parameters is EXACT for geometric-basket lookbacks."""
    from spectralmc_tpu.ops.basket import (
        BasketCombine,
        BasketSpec,
        geometric_basket_effective_gbm,
        simulate_basket_underlier_rows,
    )

    spec = BasketSpec(
        weights=(0.5, 0.3, 0.2), spot_multipliers=(1.0, 1.1, 0.9),
        vol_multipliers=(1.0, 1.3, 0.7),
        correlation=((1.0, 0.5, 0.2), (0.5, 1.0, 0.4), (0.2, 0.4, 1.0)),
        combine=BasketCombine.GEOMETRIC,
    )
    c = make_contract(strike=98.0)
    arr = c.as_array(jnp.float32)
    u = simulate_basket_underlier_rows(
        jax.random.PRNGKey(13), arr, spec=spec, timesteps=6, rows=256, cols=1024,
        dtype=jnp.float32, payoff=PayoffKind.LOOKBACK_FIXED_PUT,
    )
    prices = terminal_to_prices(u.reshape(-1), arr, normalize=False, dtype=jnp.float32)
    mc = float(jnp.mean(prices.put_payoffs))
    se = float(jnp.std(prices.put_payoffs)) / np.sqrt(prices.put_payoffs.size)
    g0, vol_eff, div_eff = geometric_basket_effective_gbm(
        c.as_array(jnp.float64), spec, dtype=jnp.float64
    )
    lb = lookback_price(
        g0, c.strike, c.maturity, c.rate, div_eff, vol_eff, timesteps=6
    )
    z = abs(mc - lb.fixed_put) / se
    assert z < 4.0, f"basket fixed_put: z={z} mc={mc} oracle={lb.fixed_put}"


def test_mc_greeks_valid_for_lookback_vs_oracle_fd() -> None:
    """IPA is valid for lookbacks — delta gates against central differences
    of the survival oracle (the product lives in the PUT channel)."""
    from spectralmc_tpu.ops.greeks import OptionSide, mc_greeks

    sim = make_simulation_params(
        payoff=PayoffKind.LOOKBACK_FIXED_CALL,
        normalization=ForwardNormalization.NONE,
        timesteps=6, network_size=2048, batches_per_mc_run=128,
    )
    c = make_contract(strike=105.0)
    g = mc_greeks(sim, c, option=OptionSide.PUT)
    h = 0.5

    def price(s: float) -> float:
        return lookback_price(
            s, c.strike, c.maturity, c.rate, c.div_yield, c.vol, timesteps=6
        ).fixed_call

    want = (price(c.spot + h) - price(c.spot - h)) / (2.0 * h)
    assert g.by_field["spot"] == pytest.approx(want, rel=0.10)
    assert np.isfinite(g.price) and g.price > 0.0


def test_term_bucket_greeks_refuses_lookback() -> None:
    from spectralmc_tpu.ops.gbm import TermStructure
    from spectralmc_tpu.ops.greeks import OptionSide, term_bucket_greeks

    sim = make_simulation_params(
        payoff=PayoffKind.LOOKBACK_FIXED_PUT,
        normalization=ForwardNormalization.NONE,
        term=TermStructure(vol_shape=(1.1, 1.0, 0.9, 1.0)),
    )
    with pytest.raises(ValueError, match="lookback"):
        term_bucket_greeks(sim, make_contract(), option=OptionSide.PUT)


def test_lookback_pallas_interpret_zero_bits_closed_form() -> None:
    """Interpret mode stubs the PRNG to zeros → a deterministic drift walk
    with per-step z = r = sqrt(-2 ln 2^-25) (test_gbm_pallas discipline).
    The path is monotone increasing, so M = S_T and m = S_0 exactly — all
    four encodings have closed forms we pin."""
    from tests.helpers.kernels import zero_bits

    from spectralmc_tpu.ops.gbm_pallas import simulate_underlier_rows_pallas

    c = make_contract(strike=104.0)
    arr = c.as_array(jnp.float32)
    n = 4
    kwargs = dict(timesteps=n, rows=8, cols=128, dtype=jnp.float32,
                  scheme=PathScheme.LOG_EULER, interpret=True)
    key = jax.random.PRNGKey(9)
    r = np.sqrt(-2.0 * np.log(np.float32(2.0**-25)))
    dt = c.maturity / n
    drift = (c.rate - c.div_yield - 0.5 * c.vol**2) * dt
    s_t = c.spot * np.exp(n * drift + n * c.vol * np.sqrt(dt) * r)  # increasing walk
    want = {
        PayoffKind.LOOKBACK_FIXED_CALL: 2.0 * c.strike - s_t,  # M = S_T
        PayoffKind.LOOKBACK_FIXED_PUT: c.spot,  # m = S_0
        PayoffKind.LOOKBACK_FLOAT_PUT: c.strike,  # M − S_T = 0
        PayoffKind.LOOKBACK_FLOAT_CALL: c.strike - (s_t - c.spot),
    }
    with zero_bits():
        for payoff, expected in want.items():
            got = np.asarray(
                simulate_underlier_rows_pallas(key, arr, payoff=payoff, **kwargs)
            )
            assert np.allclose(got, got[0, 0]), payoff.value
            np.testing.assert_allclose(got[0, 0], expected, rtol=2e-4, err_msg=payoff.value)


def test_lookback_row_offset_shard_stability() -> None:
    c = make_contract(strike=101.0)
    arr = c.as_array(jnp.float32)
    kwargs = dict(timesteps=4, cols=64, dtype=jnp.float32,
                  scheme=PathScheme.LOG_EULER, payoff=PayoffKind.LOOKBACK_FLOAT_CALL)
    full = simulate_underlier_rows(jax.random.PRNGKey(4), arr, rows=8, **kwargs)
    lo = simulate_underlier_rows(jax.random.PRNGKey(4), arr, rows=4, row_offset=0, **kwargs)
    hi = simulate_underlier_rows(jax.random.PRNGKey(4), arr, rows=4, row_offset=4, **kwargs)
    np.testing.assert_array_equal(np.asarray(full), np.vstack([lo, hi]))


def test_lookback_proto_round_trip() -> None:
    from spectralmc_tpu.serialization.converters import (
        sim_params_from_proto,
        sim_params_to_proto,
    )

    sim = make_simulation_params(
        payoff=PayoffKind.LOOKBACK_FLOAT_PUT, normalization=ForwardNormalization.NONE
    )
    back = expect_success(sim_params_from_proto(sim_params_to_proto(sim)))
    assert back == sim
    assert back.payoff == PayoffKind.LOOKBACK_FLOAT_PUT


def test_lookback_pricer_trains_resumes_and_prices() -> None:
    """Trainer over a lookback payoff: training runs, resume is bit-exact,
    predict puts finite with NaN calls (no parity — E[extreme] unknown)."""
    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
    from spectralmc_tpu.training.trainer import (
        GbmCVNNPricer,
        GbmCVNNPricerConfig,
        build_training_config,
    )
    from tests.helpers.factories import CONTRACT_BOUNDS

    sim = make_simulation_params(
        timesteps=4, network_size=16, batches_per_mc_run=4,
        payoff=PayoffKind.LOOKBACK_FIXED_PUT,
        normalization=ForwardNormalization.NONE,
    )
    cvnn = expect_success(
        build_cvnn_config(layers=[LinearCfg(width=16, activation=Activation.ZRELU)], seed=5)
    )
    pricer = expect_success(
        GbmCVNNPricer.create(GbmCVNNPricerConfig(sim=sim, bounds=CONTRACT_BOUNDS, cvnn=cvnn))
    )
    tc = expect_success(build_training_config(num_batches=6, batch_size=4, learning_rate=2e-3))
    expect_success(pricer.train(tc))
    resumed = expect_success(GbmCVNNPricer.create(pricer.snapshot()))
    tc3 = expect_success(build_training_config(num_batches=3, batch_size=4, learning_rate=2e-3))
    np.testing.assert_array_equal(
        expect_success(pricer.train(tc3)).losses,
        expect_success(resumed.train(tc3)).losses,
    )
    pred = resumed.predict_price([make_contract()])
    assert np.isfinite(pred.put).all()
    assert np.isnan(pred.call).all()  # no closed-form E[extreme]: no parity route
