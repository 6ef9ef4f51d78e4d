"""Digital (cash-or-nothing) payoffs across all four dynamics, both engines.

The ±1 synthetic underlier u = K + sign(S_T − K) prices BOTH cash-or-nothing
channels through the unchanged vanilla pipeline: df·max(K−u,0) = df·1{S_T<K}
and df·max(u−K,0) = df·1{S_T>K}. Oracle: ``ops/analytic.py::digital_price``
— exact for the log-Euler terminal law (flat or curved), plus the Merton
series and the geometric-basket effective-GBM mapping. Structural gates: the
digital draw shares TERMINAL's bit stream, the two channels partition df,
MEAN normalization is refused (the encoding is not scale-equivariant), and
IPA Greeks are refused (a.e.-zero pathwise derivative → bump_greeks).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectralmc_tpu.core.errors.gbm import InvalidSimulationParams
from spectralmc_tpu.ops.analytic import digital_price
from spectralmc_tpu.ops.gbm import (
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


def test_digital_config_validation() -> None:
    common = dict(timesteps=2, network_size=8, batches_per_mc_run=2, mc_seed=1)
    mean_norm = build_simulation_params(
        **common, payoff=PayoffKind.DIGITAL, normalization=ForwardNormalization.MEAN
    )
    err = expect_failure(mean_norm)
    assert isinstance(err, InvalidSimulationParams)
    assert "scale-equivariant" in err.reason
    stray_barrier = build_simulation_params(
        **common, payoff=PayoffKind.DIGITAL, barrier_rel=1.5
    )
    assert isinstance(expect_failure(stray_barrier), InvalidSimulationParams)
    ok = expect_success(
        build_simulation_params(
            **common, payoff=PayoffKind.DIGITAL, normalization=ForwardNormalization.NONE
        )
    )
    assert ok.payoff == PayoffKind.DIGITAL


def test_digital_closed_form_mean_support() -> None:
    from spectralmc_tpu.ops.basket import BasketCombine

    assert has_closed_form_mean(ModelKind.GBM, PayoffKind.DIGITAL)
    assert has_closed_form_mean(ModelKind.MERTON_JUMP, PayoffKind.DIGITAL)
    assert not has_closed_form_mean(ModelKind.HESTON, PayoffKind.DIGITAL)
    assert has_closed_form_mean(
        ModelKind.BASKET_GBM, PayoffKind.DIGITAL, combine=BasketCombine.GEOMETRIC
    )
    assert not has_closed_form_mean(
        ModelKind.BASKET_GBM, PayoffKind.DIGITAL, combine=BasketCombine.ARITHMETIC
    )


def test_digital_mean_reproduces_oracle_parity() -> None:
    """(E[u] − K)·df must equal call − put of the analytic digitals — the
    generic underlier-parity route reproduces digital parity exactly."""
    c = make_contract(strike=105.0, maturity=1.3)
    eu = expected_underlier_mean(
        c.as_array(jnp.float64), timesteps=8, payoff=PayoffKind.DIGITAL, dtype=jnp.float64
    )
    put_an, call_an = digital_price(
        c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol
    )
    df = np.exp(-c.rate * c.maturity)
    assert float(eu - c.strike) * df == pytest.approx(
        float(call_an - put_an), rel=1e-10
    )
    # and the two channels partition df: put + call = df·1 (cash either way)
    assert float(put_an + call_an) == pytest.approx(df, rel=1e-10)


def _digital_mc(contract, *, timesteps=8, rows=128, cols=1024, key=11, **sim_kwargs):
    arr = contract.as_array(jnp.float32)
    vals = simulate_underlier_rows(
        jax.random.PRNGKey(key),
        arr,
        timesteps=timesteps,
        rows=rows,
        cols=cols,
        dtype=jnp.float32,
        scheme=PathScheme.LOG_EULER,
        payoff=PayoffKind.DIGITAL,
        **sim_kwargs,
    )
    return terminal_to_prices(vals.reshape(-1), arr, normalize=False, dtype=jnp.float32)


@pytest.mark.parametrize("strike,side", [(95.0, "put"), (105.0, "call"), (100.0, "call")])
def test_gbm_digital_matches_oracle(strike: float, side: str) -> None:
    c = make_contract(strike=strike)
    prices = _digital_mc(c)
    payoffs = prices.put_payoffs if side == "put" else prices.call_payoffs
    mc = float(jnp.mean(payoffs))
    se = float(jnp.std(payoffs)) / np.sqrt(payoffs.size)
    put_an, call_an = digital_price(c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol)
    want = float(put_an if side == "put" else call_an)
    z = abs(mc - want) / se
    assert z < 4.0, f"K={strike} {side}: z={z} mc={mc} oracle={want}"


def test_digital_channels_partition_df() -> None:
    """Per path exactly one channel pays df (sign = ±1 a.s. in floats)."""
    c = make_contract(strike=103.0)
    prices = _digital_mc(c, rows=16, cols=256)
    df = np.exp(-c.rate * c.maturity)
    total = np.asarray(prices.put_payoffs + prices.call_payoffs)
    np.testing.assert_allclose(total, df, rtol=1e-6)


def test_digital_same_stream_as_terminal() -> None:
    """The digital draw is a pure transform of TERMINAL's bit stream."""
    c = make_contract(strike=104.0)
    arr = c.as_array(jnp.float32)
    kwargs = dict(timesteps=6, rows=8, cols=128, dtype=jnp.float32)
    term = simulate_terminal_rows(
        jax.random.PRNGKey(3), arr, scheme=PathScheme.LOG_EULER, **kwargs
    )
    dig = simulate_underlier_rows(
        jax.random.PRNGKey(3),
        arr,
        scheme=PathScheme.LOG_EULER,
        payoff=PayoffKind.DIGITAL,
        **kwargs,
    )
    np.testing.assert_array_equal(
        np.asarray(dig), np.asarray(c.strike + jnp.sign(term - c.strike))
    )


def test_gbm_digital_term_structure_matches_effective_oracle() -> None:
    from spectralmc_tpu.ops.gbm import TermStructure

    term = TermStructure(
        vol_shape=(1.3, 1.0, 0.8, 0.9), rate_shape=(1.2, 1.0, 0.9, 0.9),
        div_shape=(1.0, 1.1, 1.0, 0.9),
    )
    c = make_contract(strike=102.0)
    prices = _digital_mc(c, timesteps=4, rows=256, cols=1024, term=term)
    put_an, call_an = digital_price(
        c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol,
        vol_shape=term.vol_shape, rate_shape=term.rate_shape, div_shape=term.div_shape,
    )
    for side, want in (("put", put_an), ("call", call_an)):
        payoffs = prices.put_payoffs if side == "put" else prices.call_payoffs
        mc = float(jnp.mean(payoffs))
        se = float(jnp.std(payoffs)) / np.sqrt(payoffs.size)
        assert abs(mc - float(want)) / se < 4.0, f"{side}: mc={mc} want={float(want)}"
    # curved E[u] feeds the same parity identity as the flat case
    eu = expected_underlier_mean(
        c.as_array(jnp.float64), timesteps=4, payoff=PayoffKind.DIGITAL,
        dtype=jnp.float64, term=term,
    )
    vs = term.shapes(4)
    df_eff = np.exp(-c.rate * (sum(vs[1]) / len(vs[1])) * c.maturity)
    assert float(eu - c.strike) * df_eff == pytest.approx(
        float(call_an - put_an), rel=1e-6
    )


def test_merton_digital_matches_series_mean() -> None:
    from spectralmc_tpu.ops.merton import (
        MertonContract,
        merton_expected_underlier_mean,
        simulate_merton_underlier_rows,
    )

    c = MertonContract(
        spot=100.0, strike=104.0, maturity=1.0, rate=0.03, div_yield=0.01,
        vol=0.2, lam=0.8, jump_mean=-0.08, jump_std=0.15,
    )
    arr = c.as_array(jnp.float32)
    u = simulate_merton_underlier_rows(
        jax.random.PRNGKey(5), arr, timesteps=8, rows=256, cols=1024,
        dtype=jnp.float32, payoff=PayoffKind.DIGITAL,
    )
    eu = merton_expected_underlier_mean(
        c.as_array(jnp.float64), timesteps=8, payoff=PayoffKind.DIGITAL, dtype=jnp.float64
    )
    assert eu is not None
    mc_mean = float(jnp.mean(u))
    se = float(jnp.std(u)) / np.sqrt(u.size)
    assert abs(mc_mean - float(eu)) / se < 4.0
    # λ → 0 collapses the series to the plain Black digital probability
    c0 = MertonContract(
        spot=100.0, strike=104.0, maturity=1.0, rate=0.03, div_yield=0.01,
        vol=0.2, lam=0.0, jump_mean=-0.08, jump_std=0.15,
    )
    eu0 = merton_expected_underlier_mean(
        c0.as_array(jnp.float64), timesteps=8, payoff=PayoffKind.DIGITAL, dtype=jnp.float64
    )
    put_an, call_an = digital_price(100.0, 104.0, 1.0, 0.03, 0.01, 0.2)
    df = np.exp(-0.03)
    assert float(eu0 - 104.0) * df == pytest.approx(float(call_an - put_an), rel=1e-9)


def test_heston_digital_finite_and_no_parity() -> None:
    from spectralmc_tpu.ops.heston import (
        HestonContract,
        heston_expected_underlier_mean,
        simulate_heston_underlier_rows,
    )

    c = HestonContract(
        spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.0,
        v0=0.04, kappa=1.5, theta=0.04, xi=0.4, rho=-0.6,
    )
    arr = c.as_array(jnp.float32)
    u = simulate_heston_underlier_rows(
        jax.random.PRNGKey(9), arr, timesteps=8, rows=64, cols=512,
        dtype=jnp.float32, payoff=PayoffKind.DIGITAL,
    )
    prices = terminal_to_prices(u.reshape(-1), arr[:6], normalize=False, dtype=jnp.float32)
    df = np.exp(-0.03)
    put = float(jnp.mean(prices.put_payoffs))
    assert 0.0 < put < df
    assert (
        heston_expected_underlier_mean(
            arr, timesteps=8, payoff=PayoffKind.DIGITAL, dtype=jnp.float32
        )
        is None
    )


def test_basket_digital_geometric_effective_oracle() -> None:
    from spectralmc_tpu.ops.basket import (
        BasketCombine,
        BasketSpec,
        expected_basket_underlier_mean,
        geometric_basket_effective_gbm,
        simulate_basket_underlier_rows,
    )

    spec = BasketSpec(
        weights=(0.5, 0.3, 0.2),
        spot_multipliers=(1.0, 1.1, 0.9),
        vol_multipliers=(1.0, 1.3, 0.7),
        correlation=((1.0, 0.5, 0.2), (0.5, 1.0, 0.4), (0.2, 0.4, 1.0)),
        combine=BasketCombine.GEOMETRIC,
    )
    c = make_contract(strike=98.0)
    arr = c.as_array(jnp.float32)
    u = simulate_basket_underlier_rows(
        jax.random.PRNGKey(13), arr, spec=spec, timesteps=6, rows=256, cols=1024,
        dtype=jnp.float32, payoff=PayoffKind.DIGITAL,
    )
    prices = terminal_to_prices(u.reshape(-1), arr, normalize=False, dtype=jnp.float32)
    g0, vol_eff, div_eff = geometric_basket_effective_gbm(
        c.as_array(jnp.float64), spec, dtype=jnp.float64
    )
    put_an, call_an = digital_price(g0, c.strike, c.maturity, c.rate, div_eff, vol_eff)
    for side, want in (("put", put_an), ("call", call_an)):
        payoffs = prices.put_payoffs if side == "put" else prices.call_payoffs
        mc = float(jnp.mean(payoffs))
        se = float(jnp.std(payoffs)) / np.sqrt(payoffs.size)
        assert abs(mc - float(want)) / se < 4.0, f"{side}: mc={mc} want={float(want)}"
    # the closed-form mean agrees with the effective-GBM digital parity
    eu = expected_basket_underlier_mean(
        c.as_array(jnp.float64), spec, timesteps=6, payoff=PayoffKind.DIGITAL,
        dtype=jnp.float64,
    )
    df = np.exp(-c.rate * c.maturity)
    assert float(eu - c.strike) * df == pytest.approx(float(call_an - put_an), rel=1e-9)
    arith = BasketSpec(
        weights=spec.weights, spot_multipliers=spec.spot_multipliers,
        vol_multipliers=spec.vol_multipliers, correlation=spec.correlation,
        combine=BasketCombine.ARITHMETIC,
    )
    assert (
        expected_basket_underlier_mean(
            c.as_array(jnp.float64), arith, timesteps=6, payoff=PayoffKind.DIGITAL,
            dtype=jnp.float64,
        )
        is None
    )


def test_digital_pallas_wrapper_transform_interpret_mode() -> None:
    """The Pallas route is the terminal kernel + sign transform, bit-exactly
    (under the zero-bit stream the kernels still run the same
    program, so the transform identity is exact)."""
    from tests.helpers.kernels import zero_bits

    from spectralmc_tpu.ops.gbm_pallas import (
        simulate_terminal_rows_pallas,
        simulate_underlier_rows_pallas,
    )

    c = make_contract(strike=102.0)
    arr = c.as_array(jnp.float32)
    kwargs = dict(timesteps=4, rows=8, cols=128, dtype=jnp.float32,
                  scheme=PathScheme.LOG_EULER, interpret=True)
    with zero_bits():
        term = simulate_terminal_rows_pallas(jax.random.PRNGKey(2), arr, **kwargs)
        dig = simulate_underlier_rows_pallas(
            jax.random.PRNGKey(2), arr, payoff=PayoffKind.DIGITAL, **kwargs
        )
    np.testing.assert_array_equal(
        np.asarray(dig), np.asarray(c.strike + jnp.sign(term - c.strike))
    )


def test_digital_row_offset_shard_stability() -> None:
    c = make_contract(strike=101.0)
    arr = c.as_array(jnp.float32)
    kwargs = dict(timesteps=4, cols=64, dtype=jnp.float32,
                  scheme=PathScheme.LOG_EULER, payoff=PayoffKind.DIGITAL)
    full = simulate_underlier_rows(jax.random.PRNGKey(4), arr, rows=8, **kwargs)
    lo = simulate_underlier_rows(jax.random.PRNGKey(4), arr, rows=4, row_offset=0, **kwargs)
    hi = simulate_underlier_rows(jax.random.PRNGKey(4), arr, rows=4, row_offset=4, **kwargs)
    np.testing.assert_array_equal(np.asarray(full), np.vstack([lo, hi]))


def test_mc_greeks_refuses_digital_and_bump_estimates_delta() -> None:
    from spectralmc_tpu.ops.greeks import OptionSide, bump_greeks, mc_greeks

    sim = make_simulation_params(
        payoff=PayoffKind.DIGITAL,
        normalization=ForwardNormalization.NONE,
        timesteps=4,
        network_size=4096,
        batches_per_mc_run=256,
    )
    c = make_contract(strike=104.0)
    with pytest.raises(ValueError, match="indicator payoffs"):
        mc_greeks(sim, c, option=OptionSide.CALL)
    g = bump_greeks(sim, c, option=OptionSide.CALL)
    # analytic digital-call delta by autodiff of the closed form
    want = float(
        jax.grad(
            lambda s: digital_price(s, c.strike, c.maturity, c.rate, c.div_yield, c.vol)[1]
        )(jnp.float64(c.spot))
    )
    assert g.by_field["spot"] == pytest.approx(want, rel=0.25)
    assert g.by_field["spot"] > 0.0


def test_digital_proto_round_trip() -> None:
    from spectralmc_tpu.serialization.converters import (
        sim_params_from_proto,
        sim_params_to_proto,
    )

    sim = make_simulation_params(
        payoff=PayoffKind.DIGITAL, normalization=ForwardNormalization.NONE
    )
    back = expect_success(sim_params_from_proto(sim_params_to_proto(sim)))
    assert back == sim
    assert back.payoff == PayoffKind.DIGITAL


def test_digital_pricer_trains_and_prices_with_parity() -> None:
    """Trainer over the digital payoff: training runs, predict puts land in
    [0, df], and the call channel rides the closed-form parity exactly."""
    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
    from spectralmc_tpu.training.trainer import (
        GbmCVNNPricer,
        GbmCVNNPricerConfig,
        build_training_config,
    )
    from tests.helpers.factories import CONTRACT_BOUNDS

    sim = make_simulation_params(
        timesteps=4, network_size=32, batches_per_mc_run=8,
        payoff=PayoffKind.DIGITAL, normalization=ForwardNormalization.NONE,
    )
    cvnn = expect_success(
        build_cvnn_config(layers=[LinearCfg(width=16, activation=Activation.ZRELU)], seed=5)
    )
    pricer = expect_success(
        GbmCVNNPricer.create(GbmCVNNPricerConfig(sim=sim, bounds=CONTRACT_BOUNDS, cvnn=cvnn))
    )
    tc = expect_success(build_training_config(num_batches=2, batch_size=4, learning_rate=1e-3))
    result = expect_success(pricer.train(tc))
    assert np.all(np.isfinite(result.losses))
    contracts = [make_contract(strike=97.0), make_contract(strike=103.0)]
    pred = pricer.predict_price(contracts)
    df = np.exp(-np.array([c.rate * c.maturity for c in contracts]))
    assert np.all(np.isfinite(pred.put))
    # the call channel is put + (E[u] − K)·df — digital parity, exact
    for i, c in enumerate(contracts):
        eu = expected_underlier_mean(
            c.as_array(jnp.float64), timesteps=4, payoff=PayoffKind.DIGITAL,
            dtype=jnp.float64,
        )
        assert pred.call[i] == pytest.approx(
            pred.put[i] + float(eu - c.strike) * df[i], rel=1e-4, abs=1e-5
        )
