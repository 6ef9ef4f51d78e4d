"""Forward-start (strike-setting) options across all four dynamics.

The underlier u = spot·S_T/S_m re-bases the strike-setting ratio to today's
spot so the vanilla channels price the traded forward-start put/call with
relative strike K/spot. Exact oracle (flat AND curved GBM):
``ops/analytic.py::forward_start_price`` — ln u is Gaussian in the tail
increments alone, zero discretization slop. E[u] = spot·e^{(r−q)(T−t_m)} is
exact for GBM, Heston AND Merton (per-step discounted-spot martingale), so
parity and MEAN normalization work for all three; only the arithmetic basket
refuses. Simulation is state-free for GBM/Merton/geometric baskets (tail
integration only — the Pallas engines reuse the TERMINAL kernels at the tail
length); Heston/arithmetic baskets walk the full path and capture state at
t_m. IPA Greeks valid; the payoff is homogeneous of degree 1 in (spot,
strike), so spot·Δ + K·∂K = price exactly (Euler's identity) and vol
buckets before t_m carry zero vega.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from tests.helpers.kernels import zero_bits

from spectralmc_tpu.core.errors.gbm import InvalidSimulationParams
from spectralmc_tpu.ops.analytic import forward_start_price
from spectralmc_tpu.ops.gbm import (
    ForwardNormalization,
    ModelKind,
    PathScheme,
    PayoffKind,
    TermStructure,
    build_simulation_params,
    expected_underlier_mean,
    has_closed_form_mean,
    simulate_underlier_rows,
)
from tests.helpers.factories import make_contract, make_simulation_params
from tests.helpers.result_utils import expect_failure, expect_success

FS = PayoffKind.FORWARD_START


def _z(sample: np.ndarray, target: float) -> float:
    return float((sample.mean() - target) / (sample.std() / math.sqrt(sample.size)))


def _mc(contract, *, timesteps: int, m: int, rows: int = 512, cols: int = 1024,
        seed: int = 7, term: TermStructure | None = None,
        scheme: PathScheme = PathScheme.LOG_EULER):
    arr = contract.as_array(jnp.float32)
    u = simulate_underlier_rows(
        jax.random.PRNGKey(seed), arr, timesteps=timesteps, rows=rows, cols=cols,
        dtype=jnp.float32, scheme=scheme, payoff=FS, forward_start_step=m, term=term,
    )
    return np.asarray(u, np.float64).ravel()


def test_forward_start_config_validation() -> None:
    common = dict(timesteps=8, network_size=8, batches_per_mc_run=2, mc_seed=1)
    missing = expect_failure(build_simulation_params(**common, payoff=FS))
    assert isinstance(missing, InvalidSimulationParams)
    assert missing.field == "forward_start_step"
    for bad in (0, 8, 9, -1):
        err = expect_failure(
            build_simulation_params(**common, payoff=FS, forward_start_step=bad)
        )
        assert isinstance(err, InvalidSimulationParams), bad
    stray = expect_failure(
        build_simulation_params(**common, forward_start_step=3)  # terminal payoff
    )
    assert "takes no strike-setting date" in stray.reason
    ok = expect_success(
        build_simulation_params(
            **common, payoff=FS, forward_start_step=3,
            normalization=ForwardNormalization.MEAN,  # allowed: closed-form E[u]
        )
    )
    assert ok.forward_start_step == 3
    # Heston gets MEAN normalization too (martingale E[u]) — unlike variance
    bounds_ok = build_simulation_params(
        **common, payoff=FS, forward_start_step=3, model=ModelKind.HESTON,
        normalization=ForwardNormalization.MEAN,
    )
    assert expect_success(bounds_ok).model is ModelKind.HESTON


def test_forward_start_closed_form_mean_support() -> None:
    from spectralmc_tpu.ops.basket import BasketCombine

    assert has_closed_form_mean(ModelKind.GBM, FS)
    assert has_closed_form_mean(ModelKind.HESTON, FS)
    assert has_closed_form_mean(ModelKind.MERTON_JUMP, FS)
    assert has_closed_form_mean(ModelKind.BASKET_GBM, FS, combine=BasketCombine.GEOMETRIC)
    assert not has_closed_form_mean(
        ModelKind.BASKET_GBM, FS, combine=BasketCombine.ARITHMETIC
    )


@pytest.mark.parametrize("rel_strike", [0.9, 1.0, 1.1])
def test_gbm_forward_start_matches_exact_oracle(rel_strike: float) -> None:
    c = make_contract(strike=100.0 * rel_strike, vol=0.25, maturity=1.5)
    n, m = 16, 6
    u = _mc(c, timesteps=n, m=m)
    o = forward_start_price(
        c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol,
        timesteps=n, start_step=m,
    )
    df = math.exp(-c.rate * c.maturity)
    put = df * np.maximum(c.strike - u, 0.0)
    call = df * np.maximum(u - c.strike, 0.0)
    assert abs(_z(put, float(o.put))) < 4.0
    assert abs(_z(call, float(o.call))) < 4.0
    eu = float(
        expected_underlier_mean(
            c.as_array(jnp.float64), timesteps=n, payoff=FS, dtype=jnp.float64,
            forward_start_step=m,
        )
    )
    assert abs(_z(u, eu)) < 4.0


def test_forward_start_later_start_cheapens_the_option() -> None:
    """An ATM forward-start call's value decreases as t_m → T: less tail
    variance to run over — the defining term-structure of the product."""
    c = make_contract(strike=100.0, vol=0.25, maturity=1.5, rate=0.0, div_yield=0.0)
    prices = [
        float(
            forward_start_price(
                c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol,
                timesteps=16, start_step=m,
            ).call
        )
        for m in (2, 6, 10, 14)
    ]
    assert prices == sorted(prices, reverse=True)


def test_gbm_forward_start_term_structure_oracle() -> None:
    n, m = 16, 6
    shape = tuple(1.0 + 0.3 * math.sin(2.0 * math.pi * i / n) for i in range(n))
    term = TermStructure(vol_shape=shape)
    c = make_contract(strike=100.0, vol=0.22, maturity=1.5)
    u = _mc(c, timesteps=n, m=m, term=term)
    o = forward_start_price(
        c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol,
        timesteps=n, start_step=m, vol_shape=shape,
    )
    df = math.exp(-c.rate * c.maturity)
    put = df * np.maximum(c.strike - u, 0.0)
    assert abs(_z(put, float(o.put))) < 4.0
    # only the TAIL of the vol curve matters: bumping the head must not move
    # the oracle at all
    head_bumped = tuple(
        (s * 1.5 if i < m else s) for i, s in enumerate(shape)
    )
    o2 = forward_start_price(
        c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol,
        timesteps=n, start_step=m, vol_shape=head_bumped,
    )
    assert float(o2.put) == pytest.approx(float(o.put), rel=1e-12)


def test_heston_forward_start_exact_mean_and_smile_effect() -> None:
    from spectralmc_tpu.ops.heston import (
        HestonContract,
        heston_expected_underlier_mean,
        simulate_heston_underlier_rows,
    )

    n, m = 16, 6
    c = HestonContract(
        spot=100.0, strike=100.0, maturity=1.5, rate=0.03, div_yield=0.01,
        v0=0.04, kappa=1.5, theta=0.05, xi=0.4, rho=-0.6,
    )
    arr = c.as_array(jnp.float32)
    u = np.asarray(
        simulate_heston_underlier_rows(
            jax.random.PRNGKey(7), arr, timesteps=n, rows=512, cols=1024,
            dtype=jnp.float32, payoff=FS, forward_start_step=m,
        ),
        np.float64,
    ).ravel()
    eh = float(
        heston_expected_underlier_mean(
            arr, timesteps=n, payoff=FS, dtype=jnp.float64, forward_start_step=m
        )
    )
    assert abs(_z(u, eh)) < 4.0  # discrete martingale property, exact


def test_merton_forward_start_exact_mean() -> None:
    from spectralmc_tpu.ops.merton import (
        MertonContract,
        merton_expected_underlier_mean,
        simulate_merton_underlier_rows,
    )

    n, m = 16, 6
    c = MertonContract(
        spot=100.0, strike=100.0, maturity=1.5, rate=0.03, div_yield=0.01,
        vol=0.22, lam=0.7, jump_mean=-0.08, jump_std=0.15,
    )
    arr = c.as_array(jnp.float32)
    u = np.asarray(
        simulate_merton_underlier_rows(
            jax.random.PRNGKey(7), arr, timesteps=n, rows=512, cols=1024,
            dtype=jnp.float32, payoff=FS, forward_start_step=m,
        ),
        np.float64,
    ).ravel()
    em = float(
        merton_expected_underlier_mean(
            arr, timesteps=n, payoff=FS, dtype=jnp.float64, forward_start_step=m
        )
    )
    assert abs(_z(u, em)) < 4.0


def test_basket_forward_start_geometric_oracle_arithmetic_structural() -> None:
    from spectralmc_tpu.ops.basket import (
        BasketCombine,
        BasketSpec,
        expected_basket_underlier_mean,
        geometric_basket_effective_gbm,
        simulate_basket_underlier_rows,
    )

    spec = BasketSpec(
        weights=(0.5, 0.3, 0.2), spot_multipliers=(1.0, 0.9, 1.1),
        vol_multipliers=(1.0, 1.3, 0.7),
        correlation=((1.0, 0.5, 0.2), (0.5, 1.0, 0.4), (0.2, 0.4, 1.0)),
        combine=BasketCombine.GEOMETRIC,
    )
    n, m = 16, 6
    c = make_contract(strike=100.0, vol=0.22, maturity=1.5)
    arr = c.as_array(jnp.float32)
    u = np.asarray(
        simulate_basket_underlier_rows(
            jax.random.PRNGKey(7), arr, spec=spec, timesteps=n, rows=256, cols=512,
            dtype=jnp.float32, payoff=FS, forward_start_step=m,
        ),
        np.float64,
    ).ravel()
    eb = float(
        expected_basket_underlier_mean(
            arr, spec, timesteps=n, payoff=FS, dtype=jnp.float64, forward_start_step=m
        )
    )
    assert abs(_z(u, eb)) < 4.0
    # the effective-GBM map makes the oracle exact: u/B₀ has the law of the
    # effective GBM's tail ratio, so price the put at the effective params
    g0, vol_eff, div_eff = geometric_basket_effective_gbm(arr, spec)
    o = forward_start_price(
        g0, c.strike, c.maturity, c.rate, div_eff, vol_eff,
        timesteps=n, start_step=m,
    )
    df = math.exp(-c.rate * c.maturity)
    put_mc = df * np.maximum(c.strike - u, 0.0)
    assert abs(_z(put_mc, float(o.put))) < 4.0
    spec_a = spec.model_copy(update={"combine": BasketCombine.ARITHMETIC})
    u_a = np.asarray(
        simulate_basket_underlier_rows(
            jax.random.PRNGKey(7), arr, spec=spec_a, timesteps=n, rows=64, cols=128,
            dtype=jnp.float32, payoff=FS, forward_start_step=m,
        ),
        np.float64,
    ).ravel()
    assert np.all(np.isfinite(u_a)) and np.all(u_a > 0)
    assert (
        expected_basket_underlier_mean(
            arr, spec_a, timesteps=n, payoff=FS, dtype=jnp.float64, forward_start_step=m
        )
        is None
    )


def test_forward_start_row_offset_shard_stability() -> None:
    c = make_contract(vol=0.25).as_array(jnp.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(
        timesteps=8, cols=64, dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
        payoff=FS, forward_start_step=3,
    )
    full = simulate_underlier_rows(key, c, rows=16, **kw)
    top = simulate_underlier_rows(key, c, rows=8, row_offset=0, **kw)
    bot = simulate_underlier_rows(key, c, rows=8, row_offset=8, **kw)
    np.testing.assert_array_equal(np.asarray(full), np.vstack([top, bot]))


def test_forward_start_pallas_interpret_zero_bit_replay() -> None:
    """The GBM Pallas route IS the terminal kernel at the tail length with
    maturity rescaled to preserve dt — the zero-bit replay value is the
    terminal pair-step closed form over N−m steps."""
    from spectralmc_tpu.ops.gbm_pallas import simulate_underlier_rows_pallas

    c = make_contract(vol=0.25)
    arr = c.as_array(jnp.float32)
    n, m = 16, 6
    with zero_bits():
        rows = simulate_underlier_rows_pallas(
            jax.random.PRNGKey(1), arr, timesteps=n, rows=8, cols=128,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER, payoff=FS,
            forward_start_step=m, interpret=True,
        )
    t = np.asarray(rows)
    assert t.shape == (8, 128) and np.all(np.isfinite(t)) and np.all(t > 0)
    assert np.allclose(t, t[0, 0])
    dt = c.maturity / n
    a = (c.rate - c.div_yield - 0.5 * c.vol**2) * dt
    b = c.vol * math.sqrt(dt)
    r = math.sqrt(-2.0 * math.log(np.float32(2.0**-25)))
    tail = n - m
    pairs, odd = tail // 2, tail % 2
    logx = pairs * (2 * a + b * math.sqrt(2.0) * r * math.sin(math.pi / 4.0))
    logx += odd * (a + b * r * math.sin(math.pi / 2.0))
    assert t[0, 0] == pytest.approx(c.spot * math.exp(logx), rel=1e-4)


def test_forward_start_pallas_interpret_all_dynamics_structural() -> None:
    from spectralmc_tpu.ops.basket import BasketCombine, BasketSpec
    from spectralmc_tpu.ops.gbm_pallas import (
        simulate_basket_underlier_rows_pallas,
        simulate_heston_underlier_rows_pallas,
        simulate_merton_underlier_rows_pallas,
        simulate_underlier_rows_pallas,
    )

    key = jax.random.PRNGKey(1)
    n, m = 8, 3
    c6 = make_contract(vol=0.25).as_array(jnp.float32)
    ch = jnp.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.04, 1.5, 0.05, 0.4, -0.6], jnp.float32)
    cm = jnp.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.22, 0.7, -0.08, 0.15], jnp.float32)
    spec_g = BasketSpec(
        weights=(0.6, 0.4), spot_multipliers=(1.0, 0.9), vol_multipliers=(1.0, 1.2),
        correlation=((1.0, 0.3), (0.3, 1.0)), combine=BasketCombine.GEOMETRIC,
    )
    spec_a = spec_g.model_copy(update={"combine": BasketCombine.ARITHMETIC})
    shape = tuple(1.0 + 0.2 * math.sin(i) for i in range(n))
    term = TermStructure(vol_shape=shape)
    with zero_bits():
        outs = {
            "gbm_term": simulate_underlier_rows_pallas(
                key, c6, timesteps=n, rows=8, cols=128, dtype=jnp.float32,
                scheme=PathScheme.LOG_EULER, payoff=FS, forward_start_step=m,
                term=term, interpret=True,
            ),
            "heston": simulate_heston_underlier_rows_pallas(
                key, ch, timesteps=n, rows=8, cols=128, dtype=jnp.float32,
                payoff=FS, forward_start_step=m, interpret=True,
            ),
            "merton": simulate_merton_underlier_rows_pallas(
                key, cm, timesteps=n, rows=8, cols=128, dtype=jnp.float32,
                payoff=FS, forward_start_step=m, interpret=True,
            ),
            "basket_geo": simulate_basket_underlier_rows_pallas(
                key, c6, spec=spec_g, timesteps=n, rows=8, cols=128,
                dtype=jnp.float32, payoff=FS, forward_start_step=m, interpret=True,
            ),
            "basket_arith": simulate_basket_underlier_rows_pallas(
                key, c6, spec=spec_a, timesteps=n, rows=8, cols=128,
                dtype=jnp.float32, payoff=FS, forward_start_step=m, interpret=True,
            ),
        }
    for name, out in outs.items():
        t = np.asarray(out)
        assert t.shape == (8, 128), name
        assert np.all(np.isfinite(t)), name
        # Heston's zero-bit walk collapses the ratio to 0 by design (the
        # deterministic draws explode the variance state); everyone else
        # stays strictly positive
        if name != "heston":
            assert np.all(t > 0), name
        assert np.allclose(t, t[0, 0]), name


def test_mc_greeks_forward_start_euler_homogeneity() -> None:
    """The payoff is homogeneous of degree 1 in (spot, strike) — u scales
    with spot and K is K — so the IPA Greeks must satisfy Euler's identity
    spot·Δ + K·∂K = price EXACTLY on the same draw (math, not statistics)."""
    from spectralmc_tpu.ops.greeks import OptionSide, mc_greeks

    sim = make_simulation_params(
        timesteps=8, network_size=128, batches_per_mc_run=64, payoff=FS,
        forward_start_step=3, normalization=ForwardNormalization.NONE,
    )
    c = make_contract(strike=100.0, vol=0.25)
    g = mc_greeks(sim, c, option=OptionSide.CALL, draw_index=3)
    euler = c.spot * g.by_field["spot"] + c.strike * g.by_field["strike"]
    assert euler == pytest.approx(g.price, rel=1e-4)
    assert g.by_field["spot"] > 0.0  # long the ratio
    assert g.by_field["vol"] > 0.0


def test_term_bucket_greeks_forward_start_head_buckets_zero() -> None:
    """Vol buckets before t_m carry EXACTLY zero vega (the tail ratio never
    sees them) — the sharpest structural check a ladder can have."""
    from spectralmc_tpu.ops.greeks import OptionSide, term_bucket_greeks

    n, m = 8, 3
    shape = tuple(1.0 + 0.1 * math.sin(i) for i in range(n))
    sim = make_simulation_params(
        timesteps=n, network_size=128, batches_per_mc_run=32, payoff=FS,
        forward_start_step=m, normalization=ForwardNormalization.NONE,
        term=TermStructure(vol_shape=shape),
    )
    c = make_contract(strike=100.0, vol=0.25)
    g = term_bucket_greeks(sim, c, option=OptionSide.CALL, draw_index=2)
    assert len(g.vega_buckets) == n
    for t in range(m):
        assert g.vega_buckets[t] == 0.0, t
    for t in range(m, n):
        assert g.vega_buckets[t] > 0.0, t


def test_forward_start_proto_round_trip() -> None:
    from spectralmc_tpu.serialization.converters import (
        sim_params_from_proto,
        sim_params_to_proto,
    )

    sim = make_simulation_params(
        payoff=FS, forward_start_step=2, normalization=ForwardNormalization.MEAN
    )
    back = expect_success(sim_params_from_proto(sim_params_to_proto(sim)))
    assert back == sim
    assert back.forward_start_step == 2


def test_forward_start_effect_path_validation_and_parity() -> None:
    """The SimulatePaths effect carries the knob; the interpreter mirrors the
    config gates and prices identically to the direct engine."""
    import asyncio

    from spectralmc_tpu.effects.interpreter import MonteCarloInterpreter
    from spectralmc_tpu.effects.registry import SharedRegistry
    from spectralmc_tpu.effects.types import SimulatePaths

    common = dict(
        spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
        vol=0.25, timesteps=8, batches=8, network_size=64, seed=3, counter=0,
        normalization="none", out_id="u",
    )
    reg = SharedRegistry()
    interp = MonteCarloInterpreter(reg)
    bad = asyncio.run(
        interp.interpret(SimulatePaths(**common, payoff="forward_start"))
    )
    assert bad.is_failure() and "forward_start_step" in bad.error.reason
    stray = asyncio.run(
        interp.interpret(SimulatePaths(**common, payoff="terminal", forward_start_step=3))
    )
    assert stray.is_failure() and "strike-setting" in stray.error.reason
    ok = asyncio.run(
        interp.interpret(
            SimulatePaths(**common, payoff="forward_start", forward_start_step=3)
        )
    )
    assert ok.is_success()
    put = expect_success(reg.get_array("u"))
    assert np.all(np.isfinite(np.asarray(put)))


def test_forward_start_pricer_trains_resumes_and_prices_with_parity() -> None:
    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
    from spectralmc_tpu.training.trainer import (
        GbmCVNNPricer,
        GbmCVNNPricerConfig,
        build_training_config,
    )
    from tests.helpers.factories import CONTRACT_BOUNDS

    sim = make_simulation_params(
        timesteps=4, network_size=32, batches_per_mc_run=8, payoff=FS,
        forward_start_step=2, normalization=ForwardNormalization.MEAN,
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
    snap = pricer.snapshot()
    assert snap.sim.forward_start_step == 2  # checkpointed
    resumed = expect_success(GbmCVNNPricer.create(snap))
    r1 = expect_success(pricer.train(tc))
    r2 = expect_success(resumed.train(tc))
    np.testing.assert_array_equal(r1.losses, r2.losses)
    contracts = [make_contract(strike=95.0), make_contract(strike=105.0)]
    pred = resumed.predict_price(contracts)
    assert np.all(np.isfinite(pred.put))
    df = np.exp(-np.array([c.rate * c.maturity for c in contracts]))
    for i, c in enumerate(contracts):
        eu = float(
            expected_underlier_mean(
                c.as_array(jnp.float64), timesteps=4, payoff=FS, dtype=jnp.float64,
                forward_start_step=2,
            )
        )
        assert pred.call[i] == pytest.approx(
            pred.put[i] + (eu - c.strike) * df[i], rel=1e-4, abs=1e-5
        )
