"""Cliquet (ratchet) options across all four dynamics.

The underlier u = Σ_j clip(S_{t_j·k+k}/S_{t_j·k} − 1, floor, cap) sums
locally capped/floored period returns over the reset grid; the strike field
carries the guarantee level in RETURN units so the call channel is the
globally-floored cliquet's option leg. Exact oracle (flat AND curved GBM):
``ops/analytic.py::cliquet_price`` — a lattice convolution of the
independent periods' mixed laws (atoms at floor/cap + lognormal body).
E[u] = Σ E[clip(R_j)] is closed-form for GBM (``ops/gbm.py::
expected_clipped_lognormal_return``), Merton (Poisson-mixture series) and
geometric baskets (effective GBM) → call-via-parity there; Heston and
arithmetic baskets have none. MEAN normalization is refused for ALL
dynamics (clipping is not scale-equivariant — the digital precedent).
IPA Greeks valid; the pathwise spot delta is identically 0 under log-Euler
(state-free returns, the variance-swap precedent).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectralmc_tpu.core.errors.gbm import InvalidSimulationParams
from spectralmc_tpu.ops.analytic import cliquet_price
from spectralmc_tpu.ops.gbm import (
    ForwardNormalization,
    ModelKind,
    PathScheme,
    PayoffKind,
    SimImplementation,
    TermStructure,
    build_simulation_params,
    expected_clipped_lognormal_return,
    expected_underlier_mean,
    has_closed_form_mean,
    resolve_implementation,
    simulate_underlier_rows,
)
from tests.helpers.factories import make_contract, make_simulation_params
from tests.helpers.result_utils import expect_failure, expect_success

CQ = PayoffKind.CLIQUET
KNOBS = dict(cliquet_reset_every=3, cliquet_floor=0.0, cliquet_cap=0.05)


def _z(sample: np.ndarray, target: float) -> float:
    return float((sample.mean() - target) / (sample.std() / math.sqrt(sample.size)))


def _mc(contract, *, timesteps: int, reset_every: int, floor: float, cap: float,
        rows: int = 512, cols: int = 1024, seed: int = 7,
        term: TermStructure | None = None,
        scheme: PathScheme = PathScheme.LOG_EULER):
    arr = contract.as_array(jnp.float32)
    u = simulate_underlier_rows(
        jax.random.PRNGKey(seed), arr, timesteps=timesteps, rows=rows, cols=cols,
        dtype=jnp.float32, scheme=scheme, payoff=CQ, cliquet_reset_every=reset_every,
        cliquet_floor=floor, cliquet_cap=cap, term=term,
    )
    return np.asarray(u, np.float64).ravel()


def test_cliquet_config_validation() -> None:
    common = dict(timesteps=12, network_size=8, batches_per_mc_run=2, mc_seed=1)
    missing = expect_failure(build_simulation_params(**common, payoff=CQ))
    assert isinstance(missing, InvalidSimulationParams)
    assert missing.field == "cliquet_reset_every"
    bad_div = expect_failure(
        build_simulation_params(**common, payoff=CQ, cliquet_reset_every=5,
                                cliquet_floor=0.0, cliquet_cap=0.05)
    )
    assert "divide" in bad_div.reason
    one_period = expect_failure(
        build_simulation_params(**common, payoff=CQ, cliquet_reset_every=12,
                                cliquet_floor=0.0, cliquet_cap=0.05)
    )
    assert "2 reset periods" in one_period.reason
    bad_clip = expect_failure(
        build_simulation_params(**common, payoff=CQ, cliquet_reset_every=3,
                                cliquet_floor=0.05, cliquet_cap=0.0)
    )
    assert "floor < cap" in bad_clip.reason
    too_low = expect_failure(
        build_simulation_params(**common, payoff=CQ, cliquet_reset_every=3,
                                cliquet_floor=-1.5, cliquet_cap=0.05)
    )
    assert "floor < cap" in too_low.reason
    stray = expect_failure(build_simulation_params(**common, cliquet_floor=0.0))
    assert "takes no cliquet" in stray.reason
    mean = expect_failure(
        build_simulation_params(**common, payoff=CQ, **KNOBS,
                                normalization=ForwardNormalization.MEAN)
    )
    assert "scale-equivariant" in mean.reason
    ok = expect_success(
        build_simulation_params(**common, payoff=CQ, **KNOBS,
                                normalization=ForwardNormalization.NONE)
    )
    assert ok.cliquet_reset_every == 3 and ok.cliquet_floor == 0.0
    # GBM flat log-Euler cliquets resolve to the per-period kernel on the
    # GPU; the CPU backend (this suite) resolves to XLA
    from spectralmc_tpu.ops.gbm_pallas import pallas_supported

    assert resolve_implementation(
        ok.model_copy(update={"implementation": SimImplementation.PALLAS})
    ) == (
        SimImplementation.PALLAS
        if pallas_supported(
            dtype=ok.precision.to_jnp(),
            rows=ok.batches_per_mc_run,
            cols=ok.network_size,
        )
        else SimImplementation.XLA
    )
    # EULER loses the Gaussian-sum aggregation — always the XLA scan
    assert resolve_implementation(
        ok.model_copy(
            update={
                "implementation": SimImplementation.PALLAS,
                "scheme": PathScheme.EULER,
            }
        )
    ) == SimImplementation.XLA


def test_cliquet_closed_form_mean_support() -> None:
    from spectralmc_tpu.ops.basket import BasketCombine

    assert has_closed_form_mean(ModelKind.GBM, CQ)
    assert not has_closed_form_mean(ModelKind.HESTON, CQ)
    assert has_closed_form_mean(ModelKind.MERTON_JUMP, CQ)
    assert has_closed_form_mean(ModelKind.BASKET_GBM, CQ, combine=BasketCombine.GEOMETRIC)
    assert not has_closed_form_mean(
        ModelKind.BASKET_GBM, CQ, combine=BasketCombine.ARITHMETIC
    )


@pytest.mark.parametrize("strike", [0.0, 0.04, 0.1])
def test_gbm_cliquet_matches_lattice_oracle(strike: float) -> None:
    c = make_contract(strike=strike, vol=0.25, maturity=1.5)
    n, k, f, cap = 12, 3, -0.01, 0.06
    u = _mc(c, timesteps=n, reset_every=k, floor=f, cap=cap)
    o = cliquet_price(
        c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol,
        timesteps=n, reset_every=k, local_floor=f, local_cap=cap,
    )
    df = math.exp(-c.rate * c.maturity)
    put = df * np.maximum(c.strike - u, 0.0)
    call = df * np.maximum(u - c.strike, 0.0)
    assert abs(_z(put, float(o.put))) < 4.0
    assert abs(_z(call, float(o.call))) < 4.0
    eu = float(
        expected_underlier_mean(
            c.as_array(jnp.float64), timesteps=n, payoff=CQ, dtype=jnp.float64,
            cliquet_reset_every=k, cliquet_floor=f, cliquet_cap=cap,
        )
    )
    assert abs(_z(u, eu)) < 4.0


def test_cliquet_cap_monotonicity_and_floor_value() -> None:
    """Structure: a higher local cap raises the option leg; a higher local
    floor raises E[u]. Oracle-level (exact) monotonicity checks."""
    c = make_contract(strike=0.04, vol=0.25, maturity=1.0)

    def call_at(cap: float) -> float:
        return float(
            cliquet_price(
                c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol,
                timesteps=12, reset_every=3, local_floor=0.0, local_cap=cap,
            ).call
        )

    caps = [0.02, 0.04, 0.08, 0.15]
    prices = [call_at(x) for x in caps]
    assert prices == sorted(prices)
    e_low = float(expected_clipped_lognormal_return(
        jnp.asarray(0.005), jnp.asarray(0.12), jnp.asarray(-0.05), jnp.asarray(0.05)
    ))
    e_high = float(expected_clipped_lognormal_return(
        jnp.asarray(0.005), jnp.asarray(0.12), jnp.asarray(0.0), jnp.asarray(0.05)
    ))
    assert e_high > e_low


def test_gbm_cliquet_term_structure_oracle() -> None:
    n, k = 12, 3
    shape = tuple(1.0 + 0.3 * math.sin(2.0 * math.pi * i / n) for i in range(n))
    term = TermStructure(vol_shape=shape)
    c = make_contract(strike=0.04, vol=0.22, maturity=1.5)
    u = _mc(c, timesteps=n, reset_every=k, floor=0.0, cap=0.05, term=term)
    o = cliquet_price(
        c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol,
        timesteps=n, reset_every=k, local_floor=0.0, local_cap=0.05,
        vol_shape=shape,
    )
    df = math.exp(-c.rate * c.maturity)
    call = df * np.maximum(u - c.strike, 0.0)
    assert abs(_z(call, float(o.call))) < 4.0
    eu = float(
        expected_underlier_mean(
            c.as_array(jnp.float64), timesteps=n, payoff=CQ, dtype=jnp.float64,
            term=term, cliquet_reset_every=k, cliquet_floor=0.0, cliquet_cap=0.05,
        )
    )
    assert abs(_z(u, eu)) < 4.0


def test_merton_cliquet_series_mean_and_gbm_limit() -> None:
    from spectralmc_tpu.ops.merton import (
        MertonContract,
        merton_expected_underlier_mean,
        simulate_merton_underlier_rows,
    )

    n, k, f, cap = 12, 3, 0.0, 0.05
    c = MertonContract(
        spot=100.0, strike=0.04, maturity=1.0, rate=0.03, div_yield=0.01,
        vol=0.22, lam=0.7, jump_mean=-0.08, jump_std=0.15,
    )
    arr = c.as_array(jnp.float32)
    u = np.asarray(
        simulate_merton_underlier_rows(
            jax.random.PRNGKey(7), arr, timesteps=n, rows=512, cols=1024,
            dtype=jnp.float32, payoff=CQ, cliquet_reset_every=k,
            cliquet_floor=f, cliquet_cap=cap,
        ),
        np.float64,
    ).ravel()
    em = float(
        merton_expected_underlier_mean(
            arr, timesteps=n, payoff=CQ, dtype=jnp.float64,
            cliquet_reset_every=k, cliquet_floor=f, cliquet_cap=cap,
        )
    )
    assert abs(_z(u, em)) < 4.0
    # lam = 0 must collapse to the GBM closed form exactly
    arr0 = arr.astype(jnp.float64).at[6].set(0.0)
    em0 = float(
        merton_expected_underlier_mean(
            arr0, timesteps=n, payoff=CQ, dtype=jnp.float64,
            cliquet_reset_every=k, cliquet_floor=f, cliquet_cap=cap,
        )
    )
    eg = float(
        expected_underlier_mean(
            jnp.array([100.0, 0.04, 1.0, 0.03, 0.01, 0.22], jnp.float64),
            timesteps=n, payoff=CQ, dtype=jnp.float64,
            cliquet_reset_every=k, cliquet_floor=f, cliquet_cap=cap,
        )
    )
    assert em0 == pytest.approx(eg, rel=1e-7)


def test_heston_cliquet_structural_bounds() -> None:
    from spectralmc_tpu.ops.heston import (
        HestonContract,
        heston_expected_underlier_mean,
        simulate_heston_underlier_rows,
    )

    n, k, f, cap = 12, 3, 0.0, 0.05
    c = HestonContract(
        spot=100.0, strike=0.04, maturity=1.0, rate=0.03, div_yield=0.01,
        v0=0.04, kappa=1.5, theta=0.05, xi=0.4, rho=-0.6,
    )
    arr = c.as_array(jnp.float32)
    u = np.asarray(
        simulate_heston_underlier_rows(
            jax.random.PRNGKey(7), arr, timesteps=n, rows=256, cols=512,
            dtype=jnp.float32, payoff=CQ, cliquet_reset_every=k,
            cliquet_floor=f, cliquet_cap=cap,
        ),
        np.float64,
    ).ravel()
    periods = n // k
    assert np.all(np.isfinite(u))
    assert np.all(u >= periods * f - 1e-6) and np.all(u <= periods * cap + 1e-6)
    assert 0.0 < u.mean() < periods * cap  # strictly interior: both clips bind
    assert (
        heston_expected_underlier_mean(arr, timesteps=n, payoff=CQ, dtype=jnp.float64)
        is None
    )


def test_basket_cliquet_geometric_oracle_arithmetic_structural() -> None:
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
    n, k, f, cap = 12, 3, 0.0, 0.05
    c = make_contract(strike=0.04, vol=0.22, maturity=1.0)
    arr = c.as_array(jnp.float32)
    u = np.asarray(
        simulate_basket_underlier_rows(
            jax.random.PRNGKey(7), arr, spec=spec, timesteps=n, rows=256, cols=512,
            dtype=jnp.float32, payoff=CQ, cliquet_reset_every=k,
            cliquet_floor=f, cliquet_cap=cap,
        ),
        np.float64,
    ).ravel()
    eb = float(
        expected_basket_underlier_mean(
            arr, spec, timesteps=n, payoff=CQ, dtype=jnp.float64,
            cliquet_reset_every=k, cliquet_floor=f, cliquet_cap=cap,
        )
    )
    assert abs(_z(u, eb)) < 4.0
    # the effective-GBM map makes the full lattice oracle exact for the
    # geometric combine: period returns of B ARE the effective GBM's
    g0, vol_eff, div_eff = geometric_basket_effective_gbm(arr, spec)
    o = cliquet_price(
        g0, c.strike, c.maturity, c.rate, div_eff, vol_eff,
        timesteps=n, reset_every=k, local_floor=f, local_cap=cap,
    )
    df = math.exp(-c.rate * c.maturity)
    call_mc = df * np.maximum(u - c.strike, 0.0)
    assert abs(_z(call_mc, float(o.call))) < 4.0
    spec_a = spec.model_copy(update={"combine": BasketCombine.ARITHMETIC})
    u_a = np.asarray(
        simulate_basket_underlier_rows(
            jax.random.PRNGKey(7), arr, spec=spec_a, timesteps=n, rows=64, cols=128,
            dtype=jnp.float32, payoff=CQ, cliquet_reset_every=k,
            cliquet_floor=f, cliquet_cap=cap,
        ),
        np.float64,
    ).ravel()
    periods = n // k
    assert np.all(np.isfinite(u_a))
    assert np.all(u_a >= periods * f - 1e-6) and np.all(u_a <= periods * cap + 1e-6)
    assert (
        expected_basket_underlier_mean(
            arr, spec_a, timesteps=n, payoff=CQ, dtype=jnp.float64,
            cliquet_reset_every=k, cliquet_floor=f, cliquet_cap=cap,
        )
        is None
    )


def test_cliquet_row_offset_shard_stability() -> None:
    c = make_contract(vol=0.25).as_array(jnp.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(
        timesteps=8, cols=64, dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
        payoff=CQ, cliquet_reset_every=2, cliquet_floor=0.0, cliquet_cap=0.05,
    )
    full = simulate_underlier_rows(key, c, rows=16, **kw)
    top = simulate_underlier_rows(key, c, rows=8, row_offset=0, **kw)
    bot = simulate_underlier_rows(key, c, rows=8, row_offset=8, **kw)
    np.testing.assert_array_equal(np.asarray(full), np.vstack([top, bot]))


def test_mc_greeks_cliquet_state_free_delta_and_positive_vega() -> None:
    """Period returns never see the spot level under log-Euler, so the IPA
    spot delta is identically 0.0 (the variance-swap precedent) while vega
    is strictly positive (clipped returns still breathe with vol)."""
    from spectralmc_tpu.ops.greeks import OptionSide, mc_greeks

    sim = make_simulation_params(
        timesteps=8, network_size=128, batches_per_mc_run=64, payoff=CQ,
        cliquet_reset_every=2, cliquet_floor=0.0, cliquet_cap=0.05,
        normalization=ForwardNormalization.NONE,
    )
    c = make_contract(strike=0.04, vol=0.25)
    g = mc_greeks(sim, c, option=OptionSide.CALL, draw_index=3)
    assert g.by_field["spot"] == 0.0
    assert g.by_field["vol"] > 0.0
    assert g.by_field["strike"] < 0.0  # short the guarantee level
    assert g.price > 0.0


def test_term_bucket_greeks_cliquet_euler_homogeneity() -> None:
    """Scaling the whole vol curve by λ equals scaling vol by λ, so
    Σ_t bucket_t·shape_t must equal vol·(∂price/∂vol) — gated against the
    oracle's finite difference (exact math up to FD truncation)."""
    from spectralmc_tpu.ops.greeks import OptionSide, term_bucket_greeks

    n, k = 8, 2
    shape = tuple(1.0 + 0.1 * math.sin(i) for i in range(n))
    sim = make_simulation_params(
        timesteps=n, network_size=128, batches_per_mc_run=32, payoff=CQ,
        cliquet_reset_every=k, cliquet_floor=0.0, cliquet_cap=0.05,
        normalization=ForwardNormalization.NONE,
        term=TermStructure(vol_shape=shape),
    )
    c = make_contract(strike=0.04, vol=0.25)
    g = term_bucket_greeks(sim, c, option=OptionSide.CALL, draw_index=2)
    assert len(g.vega_buckets) == n
    assert all(b > 0.0 for b in g.vega_buckets)
    # Euler identity against the SAME-DRAW scalar-vol derivative: rebuild
    # the ladder at a bumped flat multiplier and difference
    lam = 1e-3
    sim_up = make_simulation_params(
        timesteps=n, network_size=128, batches_per_mc_run=32, payoff=CQ,
        cliquet_reset_every=k, cliquet_floor=0.0, cliquet_cap=0.05,
        normalization=ForwardNormalization.NONE,
        term=TermStructure(vol_shape=tuple(s * (1 + lam) for s in shape)),
    )
    g_up = term_bucket_greeks(sim_up, c, option=OptionSide.CALL, draw_index=2)
    fd = (g_up.price - g.price) / lam
    euler = sum(b * s for b, s in zip(g.vega_buckets, shape))
    assert euler == pytest.approx(fd, rel=2e-2)


def test_cliquet_proto_round_trip() -> None:
    from spectralmc_tpu.serialization.converters import (
        sim_params_from_proto,
        sim_params_to_proto,
    )

    sim = make_simulation_params(
        payoff=CQ, cliquet_reset_every=2, cliquet_floor=0.0, cliquet_cap=0.05,
        normalization=ForwardNormalization.NONE,
    )
    back = expect_success(sim_params_from_proto(sim_params_to_proto(sim)))
    assert back == sim
    assert back.cliquet_floor == 0.0  # explicit presence survives a 0.0 level


def test_cliquet_effect_path_validation_and_parity() -> None:
    import asyncio

    from spectralmc_tpu.effects.interpreter import MonteCarloInterpreter
    from spectralmc_tpu.effects.registry import SharedRegistry
    from spectralmc_tpu.effects.types import SimulatePaths

    common = dict(
        spot=100.0, strike=0.04, maturity=1.0, rate=0.03, div_yield=0.01,
        vol=0.25, timesteps=8, batches=8, network_size=64, seed=3, counter=0,
        normalization="none", out_id="u",
    )
    reg = SharedRegistry()
    interp = MonteCarloInterpreter(reg)
    missing = asyncio.run(interp.interpret(SimulatePaths(**common, payoff="cliquet")))
    assert missing.is_failure() and "cliquet_reset_every" in missing.error.reason
    bad_grid = asyncio.run(
        interp.interpret(
            SimulatePaths(**common, payoff="cliquet", cliquet_reset_every=3,
                          cliquet_floor=0.0, cliquet_cap=0.05)
        )
    )
    assert bad_grid.is_failure() and "divide" in bad_grid.error.reason
    stray = asyncio.run(
        interp.interpret(SimulatePaths(**common, payoff="terminal", cliquet_floor=0.0))
    )
    assert stray.is_failure() and "takes no cliquet" in stray.error.reason
    mean = asyncio.run(
        interp.interpret(
            SimulatePaths(**{**common, "normalization": "mean"}, payoff="cliquet",
                          cliquet_reset_every=2, cliquet_floor=0.0, cliquet_cap=0.05)
        )
    )
    assert mean.is_failure() and "scale-equivariant" in mean.error.reason
    ok = asyncio.run(
        interp.interpret(
            SimulatePaths(**common, payoff="cliquet", cliquet_reset_every=2,
                          cliquet_floor=0.0, cliquet_cap=0.05)
        )
    )
    assert ok.is_success()
    put = expect_success(reg.get_array("u"))
    assert np.all(np.isfinite(np.asarray(put)))


def test_cliquet_pricer_trains_resumes_and_prices_with_parity() -> None:
    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
    from spectralmc_tpu.ops.sobol import BoundSpec
    from spectralmc_tpu.training.trainer import (
        GbmCVNNPricer,
        GbmCVNNPricerConfig,
        build_training_config,
    )
    from tests.helpers.factories import CONTRACT_BOUNDS

    sim = make_simulation_params(
        timesteps=4, network_size=32, batches_per_mc_run=8, payoff=CQ,
        cliquet_reset_every=2, cliquet_floor=0.0, cliquet_cap=0.05,
        normalization=ForwardNormalization.NONE,
    )
    # strike bounds in RETURN units (the variance-swap precedent)
    bounds = {**CONTRACT_BOUNDS, "strike": BoundSpec(lower=0.01, upper=0.08)}
    cvnn = expect_success(
        build_cvnn_config(layers=[LinearCfg(width=16, activation=Activation.ZRELU)], seed=5)
    )
    pricer = expect_success(
        GbmCVNNPricer.create(GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=cvnn))
    )
    tc = expect_success(build_training_config(num_batches=2, batch_size=4, learning_rate=1e-3))
    result = expect_success(pricer.train(tc))
    assert np.all(np.isfinite(result.losses))
    snap = pricer.snapshot()
    assert snap.sim.cliquet_reset_every == 2  # checkpointed
    assert snap.sim.cliquet_floor == 0.0 and snap.sim.cliquet_cap == 0.05
    resumed = expect_success(GbmCVNNPricer.create(snap))
    r1 = expect_success(pricer.train(tc))
    r2 = expect_success(resumed.train(tc))
    np.testing.assert_array_equal(r1.losses, r2.losses)
    contracts = [make_contract(strike=0.02), make_contract(strike=0.06)]
    pred = resumed.predict_price(contracts)
    assert np.all(np.isfinite(pred.put))
    df = np.exp(-np.array([c.rate * c.maturity for c in contracts]))
    for i, c in enumerate(contracts):
        eu = float(
            expected_underlier_mean(
                c.as_array(jnp.float64), timesteps=4, payoff=CQ, dtype=jnp.float64,
                cliquet_reset_every=2, cliquet_floor=0.0, cliquet_cap=0.05,
            )
        )
        assert pred.call[i] == pytest.approx(
            pred.put[i] + (eu - c.strike) * df[i], rel=1e-4, abs=1e-5
        )


def test_blackscholes_facade_threads_cliquet_knobs() -> None:
    """The BlackScholes engine facade must pass the cliquet knobs (and the
    parity mean target's) through to the simulator — regression for the
    round-3 gap where ``simulate_terminal`` dropped them and the facade
    crashed on any CLIQUET sim (gbm.py::BlackScholes.simulate_terminal)."""
    from spectralmc_tpu.ops.gbm import BlackScholes

    sim = make_simulation_params(
        timesteps=6, network_size=64, batches_per_mc_run=64,
        payoff=CQ, normalization=ForwardNormalization.NONE,
        cliquet_reset_every=2, cliquet_floor=0.0, cliquet_cap=0.05,
    )
    c = make_contract(strike=0.04)
    prices, advanced = BlackScholes(sim).price(c)
    put = float(jnp.mean(prices.put_payoffs))
    call = float(jnp.mean(prices.call_payoffs))
    ex = cliquet_price(
        c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol,
        timesteps=6, reset_every=2, local_floor=0.0, local_cap=0.05,
    )
    se = float(jnp.std(prices.put_payoffs)) / math.sqrt(64 * 64)
    assert abs(put - ex.put) < 6 * se + 1e-4
    assert call > put  # E[u] ~ 0.07 > K
    assert advanced.params.skip == sim.skip + 1


def test_blackscholes_facade_threads_forward_start_step() -> None:
    """Same facade regression for FORWARD_START: the tail-only simulator
    needs ``forward_start_step`` threaded through simulate_terminal."""
    from spectralmc_tpu.ops.analytic import forward_start_price
    from spectralmc_tpu.ops.gbm import BlackScholes

    sim = make_simulation_params(
        timesteps=6, network_size=64, batches_per_mc_run=64,
        payoff=PayoffKind.FORWARD_START, forward_start_step=2,
    )
    c = make_contract(strike=1.0)
    prices, _ = BlackScholes(sim).price(c)
    put = float(jnp.mean(prices.put_payoffs))
    ex = forward_start_price(
        c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol,
        timesteps=6, start_step=2,
    )
    se = float(jnp.std(prices.put_payoffs)) / math.sqrt(64 * 64)
    assert abs(put - ex.put) < 6 * se + 1e-4


# ---------------------------------------------------------------------------
# Round 3: the per-period Pallas kernel (stream key ``gbm_cliquet``).
# Under flat log-Euler GBM each reset period's log-return is an exact
# Gaussian sum, so the kernel draws ONE N(k·drift, k·vol²·dt) normal per
# period — the identical distribution with reset_every× fewer draws. The
# zero-bit stream (tests/helpers/kernels.py) yields all-zero bits, which pins
# u1 = 2^-25 and theta = 0 exactly — the deterministic skeleton is
# closed-form checkable; statistics are gated on the card below.
# ---------------------------------------------------------------------------


def test_cliquet_pallas_stream_key() -> None:
    from spectralmc_tpu.ops.gbm_pallas import (
        PALLAS_STREAM_VERSIONS,
        pallas_stream_version,
    )

    assert (
        pallas_stream_version(ModelKind.GBM, CQ)
        == PALLAS_STREAM_VERSIONS["gbm_cliquet"]
    )
    # the cliquet kernel is its own program: the flat/terminal key is untouched
    assert (
        pallas_stream_version(ModelKind.GBM, PayoffKind.TERMINAL)
        == PALLAS_STREAM_VERSIONS["gbm"]
    )


def _run_cliquet_interpret(
    *,
    timesteps: int = 12,
    reset_every: int = 3,
    floor: float = -0.02,
    cap: float = 0.05,
    rows: int = 8,
    cols: int = 128,
    antithetic_half: int | None = None,
    seed: int = 3,
):
    from tests.helpers.kernels import zero_bits

    from spectralmc_tpu.ops.gbm_pallas import simulate_underlier_rows_pallas

    arr = make_contract(vol=0.3).as_array(jnp.float32)
    with zero_bits():
        return simulate_underlier_rows_pallas(
            jax.random.PRNGKey(seed), arr, timesteps=timesteps, rows=rows,
            cols=cols, dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
            payoff=CQ, cliquet_reset_every=reset_every, cliquet_floor=floor,
            cliquet_cap=cap, antithetic_half=antithetic_half, interpret=True,
        )


def test_cliquet_pallas_interpret_zero_bits_closed_form() -> None:
    """Zero-bit RNG: every pair draws (z1, z2) = (r, 0) with
    r = sqrt(-2 ln 2^-25); an odd trailing period draws z = r. The clipped
    accumulator is then exact arithmetic — 12 steps / k=3 gives 4 periods =
    2 pairs; 9 steps / k=3 gives 3 periods = 1 pair + 1 single."""
    c = make_contract(vol=0.3)
    r = float(np.sqrt(-2.0 * np.log(np.float32(2.0**-25))))

    def expected(timesteps: int, k: int, floor: float, cap: float) -> float:
        n_p = timesteps // k
        dt = c.maturity / timesteps
        pd = (c.rate - c.div_yield - 0.5 * c.vol**2) * dt * k
        pv = c.vol * math.sqrt(dt * k)
        hit = float(np.clip(math.exp(pd + pv * r) - 1.0, floor, cap))
        mid = float(np.clip(math.exp(pd) - 1.0, floor, cap))
        return (n_p // 2) * (hit + mid) + (n_p % 2) * hit

    u_even = np.asarray(_run_cliquet_interpret(timesteps=12, reset_every=3))
    assert u_even.shape == (8, 128)
    assert np.allclose(u_even, u_even[0, 0])
    np.testing.assert_allclose(
        u_even[0, 0], expected(12, 3, -0.02, 0.05), rtol=1e-5
    )
    u_odd = np.asarray(
        _run_cliquet_interpret(timesteps=9, reset_every=3, floor=0.0, cap=0.08)
    )
    np.testing.assert_allclose(u_odd[0, 0], expected(9, 3, 0.0, 0.08), rtol=1e-5)


def test_cliquet_pallas_interpret_bounds_and_antithetic_mirror() -> None:
    """The accumulator is bounded in [n_periods·floor, n_periods·cap]; with
    zero bits every draw is z = +r, so the antithetic partners (odd rows)
    run the EXACT mirrored skeleton: clip(e^{pd − pv·r} − 1) replaces the top half's
    clip(e^{pd + pv·r} − 1) while the z2 = 0 period term is shared."""
    u = np.asarray(_run_cliquet_interpret(antithetic_half=4))
    n_p = 4
    assert np.all(u >= n_p * -0.02 - 1e-6) and np.all(u <= n_p * 0.05 + 1e-6)
    c = make_contract(vol=0.3)
    r = float(np.sqrt(-2.0 * np.log(np.float32(2.0**-25))))
    dt = c.maturity / 12
    pd = (c.rate - c.div_yield - 0.5 * c.vol**2) * dt * 3
    pv = c.vol * math.sqrt(dt * 3)
    mid = float(np.clip(math.exp(pd) - 1.0, -0.02, 0.05))

    def half(sign: float) -> float:
        hit = float(np.clip(math.exp(pd + sign * pv * r) - 1.0, -0.02, 0.05))
        return (n_p // 2) * (hit + mid)

    np.testing.assert_allclose(u[0::2], half(+1.0), rtol=1e-5)
    np.testing.assert_allclose(u[1::2], half(-1.0), rtol=1e-5)


@pytest.mark.card
def test_cliquet_pallas_statistics_vs_oracle_tpu(card: None) -> None:
    """On-chip: the kernel's per-period sampling must agree with BOTH the
    exact lattice oracle (price channel) and the XLA engine's estimate —
    same distribution, different bit streams."""
    from spectralmc_tpu.ops.gbm_pallas import simulate_underlier_rows_pallas

    c = make_contract(vol=0.35, strike=0.05)  # strike in RETURN units
    arr = c.as_array(jnp.float32)
    kw = dict(
        timesteps=96, rows=4096, cols=256, dtype=jnp.float32,
        scheme=PathScheme.LOG_EULER, payoff=CQ,
        cliquet_reset_every=8, cliquet_floor=0.0, cliquet_cap=0.08,
    )
    u = np.asarray(
        simulate_underlier_rows_pallas(jax.random.PRNGKey(11), arr, **kw)
    ).ravel()
    ex = cliquet_price(
        c.spot, c.strike, c.maturity, c.rate, c.div_yield, c.vol,
        timesteps=96, reset_every=8, local_floor=0.0, local_cap=0.08,
    )
    df = math.exp(-c.rate * c.maturity)
    call = df * np.maximum(u - c.strike, 0.0)
    z = _z(call, float(ex.call))
    assert abs(z) < 5.0, (call.mean(), float(ex.call), z)
    # mean of the raw accumulator vs the closed-form E[u]
    n_p = 96 // 8
    dt = c.maturity / 96
    mu = (c.rate - c.div_yield - 0.5 * c.vol**2) * dt * 8
    s = c.vol * math.sqrt(dt * 8)
    eu = n_p * float(expected_clipped_lognormal_return(
        jnp.float32(mu), jnp.float32(s), jnp.float32(0.0), jnp.float32(0.08)
    ))
    zu = _z(u, eu)
    assert abs(zu) < 5.0, (u.mean(), eu, zu)
