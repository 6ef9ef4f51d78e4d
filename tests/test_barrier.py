"""Barrier (knockout) payoffs across GBM / Heston / basket, both engines.

Oracle: ``discrete_barrier_price`` propagates the exact per-step lognormal
transition density with a knockout mask at every monitor date — the SAME
discrete monitoring the simulators implement, so the gates carry no
continuity-correction slop. Structural gates: a far barrier reproduces the
TERMINAL run bit-for-bit (same normals, mask never fires), knockout value is
monotone in the barrier level, and knocked paths zero both vanilla payoffs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectralmc_tpu.core.errors.gbm import InvalidSimulationParams
from spectralmc_tpu.ops.analytic import black_scholes_price, discrete_barrier_price
from spectralmc_tpu.ops.gbm import (
    BARRIER_PAYOFFS,
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


def test_barrier_config_validation() -> None:
    common = dict(timesteps=2, network_size=8, batches_per_mc_run=2, mc_seed=1)
    missing = build_simulation_params(**common, payoff=PayoffKind.BARRIER_UP_OUT)
    assert isinstance(expect_failure(missing), InvalidSimulationParams)
    bad_up = build_simulation_params(
        **common, payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=0.9
    )
    assert isinstance(expect_failure(bad_up), InvalidSimulationParams)
    bad_down = build_simulation_params(
        **common, payoff=PayoffKind.BARRIER_DOWN_OUT, barrier_rel=1.2
    )
    assert isinstance(expect_failure(bad_down), InvalidSimulationParams)
    stray = build_simulation_params(**common, barrier_rel=1.5)
    assert isinstance(expect_failure(stray), InvalidSimulationParams)
    from spectralmc_tpu.ops.gbm import ForwardNormalization

    mean_norm = build_simulation_params(
        **common,
        payoff=PayoffKind.BARRIER_UP_OUT,
        barrier_rel=1.5,
        normalization=ForwardNormalization.MEAN,
    )
    assert isinstance(expect_failure(mean_norm), InvalidSimulationParams)
    ok = build_simulation_params(
        **common,
        payoff=PayoffKind.BARRIER_UP_OUT,
        barrier_rel=1.5,
        normalization=ForwardNormalization.NONE,
    )
    assert expect_success(ok).barrier_rel == 1.5


def test_no_closed_form_mean_for_barriers() -> None:
    for payoff in BARRIER_PAYOFFS:
        assert not has_closed_form_mean(ModelKind.GBM, payoff)
        assert (
            expected_underlier_mean(
                make_contract().as_array(jnp.float32),
                timesteps=4,
                payoff=payoff,
                dtype=jnp.float32,
            )
            is None
        )


def _mc_price(payoff, barrier_rel, *, side="call", timesteps=8, rows=128, cols=1024, scheme=PathScheme.LOG_EULER, contract=None):
    contract = contract or make_contract()
    arr = contract.as_array(jnp.float32)
    vals = simulate_underlier_rows(
        jax.random.PRNGKey(11),
        arr,
        timesteps=timesteps,
        rows=rows,
        cols=cols,
        dtype=jnp.float32,
        scheme=scheme,
        payoff=payoff,
        barrier_rel=barrier_rel,
    )
    prices = terminal_to_prices(vals.reshape(-1), arr, normalize=False, dtype=jnp.float32)
    payoffs = prices.call_payoffs if side == "call" else prices.put_payoffs
    return float(jnp.mean(payoffs)), float(jnp.std(payoffs)) / np.sqrt(payoffs.size)


@pytest.mark.parametrize(
    "payoff,barrier_rel,side",
    [
        (PayoffKind.BARRIER_UP_OUT, 1.25, "call"),
        (PayoffKind.BARRIER_UP_OUT, 1.15, "call"),
        (PayoffKind.BARRIER_DOWN_OUT, 0.85, "put"),
        (PayoffKind.BARRIER_DOWN_OUT, 0.80, "call"),
    ],
)
def test_gbm_barrier_matches_convolution_oracle(payoff, barrier_rel, side) -> None:
    c = make_contract()
    mc, se = _mc_price(payoff, barrier_rel, side=side)
    oracle = discrete_barrier_price(
        c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol,
        timesteps=8, barrier_rel=barrier_rel,
        up=payoff == PayoffKind.BARRIER_UP_OUT,
    )
    want = float(getattr(oracle, side))
    z = abs(mc - want) / se
    assert z < 4.0, f"{payoff.value} B={barrier_rel}: z={z} mc={mc} oracle={want}"


def test_convolution_oracle_far_barrier_is_black_scholes() -> None:
    """With the barrier out of reach the oracle must collapse to Black —
    validates the oracle itself independently of the MC."""
    c = make_contract()
    far = discrete_barrier_price(
        c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol,
        timesteps=6, barrier_rel=50.0, up=True,
    )
    bs = black_scholes_price(c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol)
    assert float(far.call) == pytest.approx(float(bs.call), rel=1e-5)
    assert float(far.put) == pytest.approx(float(bs.put), rel=1e-5)


def test_far_barrier_equals_terminal_bit_exact() -> None:
    """mask never fires -> underlier rows identical to the TERMINAL run
    (same normals keying). Exercised for both schemes."""
    c = make_contract()
    arr = c.as_array(jnp.float32)
    key = jax.random.PRNGKey(5)
    for scheme in (PathScheme.LOG_EULER, PathScheme.EULER):
        terminal = simulate_terminal_rows(
            key, arr, timesteps=4, rows=8, cols=128, dtype=jnp.float32, scheme=scheme
        )
        barrier = simulate_underlier_rows(
            key, arr, timesteps=4, rows=8, cols=128, dtype=jnp.float32,
            scheme=scheme, payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=1e6,
        )
        np.testing.assert_array_equal(np.asarray(terminal), np.asarray(barrier))


def test_knockout_value_monotone_in_barrier_level() -> None:
    prices = [
        _mc_price(PayoffKind.BARRIER_UP_OUT, b, side="call")[0]
        for b in (1.10, 1.25, 1.60)
    ]
    assert prices[0] < prices[1] < prices[2], prices
    assert prices[2] <= _mc_price(PayoffKind.BARRIER_UP_OUT, 1e6, side="call")[0] * 1.001


def test_knocked_paths_zero_both_sides() -> None:
    """An immediate barrier (just above spot, high vol) knocks ~all paths;
    the masked underlier == strike zeroes put AND call payoffs."""
    c = make_contract(vol=0.6)
    arr = c.as_array(jnp.float32)
    vals = simulate_underlier_rows(
        jax.random.PRNGKey(1), arr, timesteps=16, rows=16, cols=256,
        dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
        payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=1.0000001,
    )
    prices = terminal_to_prices(vals.reshape(-1), arr, normalize=False, dtype=jnp.float32)
    knocked = np.asarray(vals.reshape(-1)) == np.float32(c.strike)
    assert knocked.mean() > 0.95
    assert np.all(np.asarray(prices.put_payoffs)[knocked] == 0.0)
    assert np.all(np.asarray(prices.call_payoffs)[knocked] == 0.0)


def test_row_offset_shard_stability_barrier() -> None:
    c = make_contract()
    arr = c.as_array(jnp.float32)
    key = jax.random.PRNGKey(3)
    kwargs = dict(
        timesteps=3, cols=128, dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
        payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=1.2,
    )
    full = simulate_underlier_rows(key, arr, rows=8, **kwargs)
    shard = simulate_underlier_rows(key, arr, rows=4, row_offset=4, **kwargs)
    np.testing.assert_array_equal(np.asarray(full[4:]), np.asarray(shard))


# --------------------------------------------------------------------------
# Pallas kernels (interpret mode on CPU)
# --------------------------------------------------------------------------


def test_pallas_barrier_structure_interpret_mode() -> None:
    """The zero-bit stream makes the kernel a
    deterministic drift walk (the discipline of test_gbm_pallas.py): each
    single step adds drift + vol·sqrt(dt)·r with r = sqrt(-2 ln 2^-25)
    (u2 = 0 => sin(2*pi*(0+1/4)) = 1). We pin the far-barrier walk to that
    exact closed form (the barrier branch must not disturb the dynamics),
    and a tight up-barrier knocks every path to strike. (Far-barrier is NOT
    bit-equal to the TERMINAL kernel here by design — TERMINAL uses the
    pair-step draw pattern, a different stream.)"""
    from tests.helpers.kernels import zero_bits

    from spectralmc_tpu.ops.gbm_pallas import simulate_underlier_rows_pallas

    c = make_contract()
    arr = c.as_array(jnp.float32)
    key = jax.random.PRNGKey(9)
    n = 4
    kwargs = dict(timesteps=n, rows=8, cols=128, dtype=jnp.float32, interpret=True)
    with zero_bits():
        far = simulate_underlier_rows_pallas(
            key, arr, scheme=PathScheme.LOG_EULER,
            payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=1e6, **kwargs
        )
        tight = simulate_underlier_rows_pallas(
            key, arr, scheme=PathScheme.LOG_EULER,
            payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=1.0000001, **kwargs
        )
    r = np.sqrt(-2.0 * np.log(np.float32(2.0**-25)))
    dt = c.maturity / n
    drift = (c.rate - c.div_yield - 0.5 * c.vol**2) * dt
    expected = c.spot * np.exp(n * drift + n * c.vol * np.sqrt(dt) * r)
    t = np.asarray(far)
    assert np.allclose(t, t[0, 0])
    np.testing.assert_allclose(t[0, 0], expected, rtol=1e-4)
    assert np.all(np.asarray(tight) == np.float32(c.strike))


def test_heston_barrier_finite_and_below_vanilla() -> None:
    from spectralmc_tpu.ops.heston import HestonContract, simulate_heston_underlier_rows

    contract = HestonContract(
        spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
        v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.7,
    )
    arr = contract.as_array(jnp.float32)
    key = jax.random.PRNGKey(2)
    kwargs = dict(timesteps=16, rows=64, cols=512, dtype=jnp.float32)
    vanilla = simulate_heston_underlier_rows(key, arr, payoff=PayoffKind.TERMINAL, **kwargs)
    knocked = simulate_heston_underlier_rows(
        key, arr, payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=1.2, **kwargs
    )
    pv = terminal_to_prices(vanilla.reshape(-1), arr, normalize=False, dtype=jnp.float32)
    pk = terminal_to_prices(knocked.reshape(-1), arr, normalize=False, dtype=jnp.float32)
    v_call, k_call = float(jnp.mean(pv.call_payoffs)), float(jnp.mean(pk.call_payoffs))
    assert np.isfinite(k_call) and 0.0 < k_call < v_call
    # far barrier == vanilla bits
    far = simulate_heston_underlier_rows(
        key, arr, payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=1e6, **kwargs
    )
    np.testing.assert_array_equal(np.asarray(vanilla), np.asarray(far))


def test_basket_barrier_monitors_basket_value() -> None:
    from spectralmc_tpu.ops.basket import build_basket_spec, simulate_basket_underlier_rows

    spec = expect_success(
        build_basket_spec(
            weights=(0.5, 0.5), correlation=((1.0, 0.3), (0.3, 1.0))
        )
    )
    c = make_contract()
    arr = c.as_array(jnp.float32)
    key = jax.random.PRNGKey(4)
    kwargs = dict(spec=spec, timesteps=8, rows=64, cols=512, dtype=jnp.float32)
    vanilla = simulate_basket_underlier_rows(key, arr, payoff=PayoffKind.TERMINAL, **kwargs)
    knocked = simulate_basket_underlier_rows(
        key, arr, payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=1.2, **kwargs
    )
    far = simulate_basket_underlier_rows(
        key, arr, payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=1e6, **kwargs
    )
    np.testing.assert_array_equal(np.asarray(vanilla), np.asarray(far))
    pv = terminal_to_prices(vanilla.reshape(-1), arr, normalize=False, dtype=jnp.float32)
    pk = terminal_to_prices(knocked.reshape(-1), arr, normalize=False, dtype=jnp.float32)
    assert 0.0 < float(jnp.mean(pk.call_payoffs)) < float(jnp.mean(pv.call_payoffs))


# --------------------------------------------------------------------------
# Integration: greeks gate, wire format, trainer
# --------------------------------------------------------------------------


def test_mc_greeks_refuses_barrier_payoffs() -> None:
    from spectralmc_tpu.ops.greeks import OptionSide, mc_greeks

    from spectralmc_tpu.ops.gbm import ForwardNormalization

    sim = make_simulation_params(
        payoff=PayoffKind.BARRIER_UP_OUT,
        barrier_rel=1.3,
        normalization=ForwardNormalization.NONE,
    )
    with pytest.raises(ValueError, match="indicator payoffs"):
        mc_greeks(sim, make_contract(), option=OptionSide.CALL)


def test_barrier_proto_round_trip() -> None:
    from spectralmc_tpu.serialization.converters import (
        sim_params_from_proto,
        sim_params_to_proto,
    )

    from spectralmc_tpu.ops.gbm import ForwardNormalization

    sim = make_simulation_params(
        payoff=PayoffKind.BARRIER_DOWN_OUT,
        barrier_rel=0.8,
        normalization=ForwardNormalization.NONE,
    )
    back = expect_success(sim_params_from_proto(sim_params_to_proto(sim)))
    assert back == sim
    plain = make_simulation_params()
    assert expect_success(sim_params_from_proto(sim_params_to_proto(plain))).barrier_rel is None


def test_barrier_pricer_trains_resumes_and_prices() -> None:
    """Trainer over the knockout payoff: loss decreases, resume bit-exact,
    predict_price puts finite with NaN calls (no parity for barriers)."""
    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
    from spectralmc_tpu.ops.gbm import ForwardNormalization
    from spectralmc_tpu.training.trainer import (
        GbmCVNNPricer,
        GbmCVNNPricerConfig,
        build_training_config,
    )
    from tests.helpers.factories import CONTRACT_BOUNDS

    sim = make_simulation_params(
        timesteps=2,
        network_size=16,
        batches_per_mc_run=4,
        payoff=PayoffKind.BARRIER_UP_OUT,
        barrier_rel=1.3,
        normalization=ForwardNormalization.NONE,
    )
    cvnn = expect_success(
        build_cvnn_config(layers=[LinearCfg(width=24, activation=Activation.MODRELU)], seed=3)
    )
    pricer = expect_success(
        GbmCVNNPricer.create(GbmCVNNPricerConfig(sim=sim, bounds=CONTRACT_BOUNDS, cvnn=cvnn))
    )
    tc = expect_success(build_training_config(num_batches=20, batch_size=8, learning_rate=3e-3))
    result = expect_success(pricer.train(tc))
    assert float(np.mean(result.losses[-5:])) < float(np.mean(result.losses[:5]))

    resumed = expect_success(GbmCVNNPricer.create(pricer.snapshot()))
    tc5 = expect_success(build_training_config(num_batches=5, batch_size=8, learning_rate=3e-3))
    np.testing.assert_array_equal(
        expect_success(pricer.train(tc5)).losses,
        expect_success(resumed.train(tc5)).losses,
    )
    pred = resumed.predict_price([make_contract()])
    assert np.isfinite(pred.put).all()
    assert np.isnan(pred.call).all()  # no put-call parity for knockouts


def test_effects_path_carries_barrier_and_matches_direct() -> None:
    """SimulatePaths→ComputeFFT with a barrier payoff interpreted == the
    direct fused-spectrum math (regression: the effect record used to drop
    barrier_rel and crash the interpreter on a valid config); a barrier
    payoff without a level is a typed MonteCarloError, not an assert."""
    import asyncio

    from spectralmc_tpu.core.result import Failure
    from spectralmc_tpu.effects.composition import sequence_effects
    from spectralmc_tpu.effects.interpreter import SpectralMCInterpreter
    from spectralmc_tpu.effects.types import ComputeFFT, SimulatePaths
    from spectralmc_tpu.ops.gbm import ForwardNormalization
    from spectralmc_tpu.training.effects_builders import build_simulation_effects
    from spectralmc_tpu.training.step import make_mc_spectrum

    sim = make_simulation_params(
        timesteps=3, network_size=16, batches_per_mc_run=8, mc_seed=11, skip=4,
        payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=1.2,
        normalization=ForwardNormalization.NONE,
    )
    c = make_contract()
    direct = make_mc_spectrum(sim)(jnp.uint32(4), c.as_array(jnp.float32))

    seq = build_simulation_effects(sim, c, out_id="prices")
    fft = ComputeFFT(in_id="prices", batches=8, network_size=16, out_id="spec")
    interp = SpectralMCInterpreter.create()
    res = asyncio.run(interp.interpret_sequence(sequence_effects([*seq.effects, fft])))
    assert not isinstance(res, Failure), res
    spec = interp.registry.get_array("spec").expect("spec")
    np.testing.assert_array_equal(np.asarray(spec), np.asarray(direct))

    # missing level -> typed failure
    bad = SimulatePaths(
        spot=c.spot, strike=c.strike, maturity=c.maturity, rate=c.rate,
        div_yield=c.div_yield, vol=c.vol, timesteps=3, batches=8, network_size=16,
        seed=11, counter=4, scheme="log_euler", normalization="none",
        payoff="barrier_up_out", model="gbm", precision="float32", out_id="x",
    )
    out = asyncio.run(interp.interpret(bad))
    assert isinstance(out, Failure)
    assert "barrier_rel" in out.error.reason


def test_knock_in_price_matches_oracle_difference() -> None:
    """in = vanilla − out under common random numbers: the MC knock-in call
    must match Black(vanilla) − discrete_barrier(out) to MC tolerance, be
    positive, and grow as the barrier comes closer (more knock-ins)."""
    from spectralmc_tpu.ops.analytic import black_scholes_price, discrete_barrier_price
    from spectralmc_tpu.ops.gbm import ForwardNormalization
    from spectralmc_tpu.ops.greeks import OptionSide, knock_in_price
    from tests.helpers.factories import make_contract, make_simulation_params

    c = make_contract(spot=100.0, strike=100.0, vol=0.2)
    prices_in = []
    for barrier_rel in (1.25, 1.4):
        sim = make_simulation_params(
            timesteps=8, network_size=256, batches_per_mc_run=256,
            payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=barrier_rel,
            normalization=ForwardNormalization.NONE,
        )
        got = knock_in_price(sim, c, option=OptionSide.CALL)
        vanilla = float(
            black_scholes_price(
                c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol
            ).call
        )
        out_oracle = float(
            discrete_barrier_price(
                c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol,
                timesteps=8, barrier_rel=barrier_rel, up=True,
            ).call
        )
        want = vanilla - out_oracle
        assert got > 0.0
        assert got == pytest.approx(want, rel=0.1, abs=0.05), (barrier_rel, got, want)
        prices_in.append(got)
    assert prices_in[0] > prices_in[1]  # closer barrier -> more knock-ins

    # non-barrier sims are refused loudly
    sim_terminal = make_simulation_params(timesteps=4, network_size=16, batches_per_mc_run=4)
    with pytest.raises(ValueError, match="barrier payoff"):
        knock_in_price(sim_terminal, c)
