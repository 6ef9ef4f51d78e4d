"""Variance-swap payoffs (realized variance) across all four dynamics.

The underlier u = RV = (1/T)·Σ(Δln S)² makes the two vanilla channels the
traded variance options — put = df·max(K−RV,0) (floor), call = df·max(RV−K,0)
(cap) — and the payer swap leg call − put = df·(E[RV] − K) rides the generic
parity route. Under flat log-Euler GBM the WHOLE distribution is known:
RV ~ (v²dt/T)·χ'²(N, λ) — ``ops/analytic.py::variance_option_price`` is an
exact discrete-grid oracle for both channels, the sharpest gate in the
barrier/lookback/American family of extensions. E[RV] is also exact for
curved GBM terms, Merton (exact transitions) and geometric baskets
(effective GBM); Heston/arithmetic-basket have no closed form (parity and
MEAN normalization gated off). IPA Greeks are valid — RV is smooth in
vol/rate and its pathwise delta is identically zero under log-Euler (the
true model delta of a variance swap).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from tests.helpers.kernels import zero_bits

from spectralmc_tpu.core.errors.gbm import InvalidSimulationParams
from spectralmc_tpu.ops.analytic import variance_fair_strike, variance_option_price
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
    terminal_to_prices,
)
from tests.helpers.factories import make_contract, make_simulation_params
from tests.helpers.result_utils import expect_failure, expect_success

VS = PayoffKind.VARIANCE_SWAP
# ATM-ish variance strike for vol 0.25 (RV ≈ v² = 0.0625)
VAR_STRIKE = 0.06


def _mc_channels(
    contract, *, timesteps: int, rows: int = 512, cols: int = 1024, seed: int = 7,
    term: TermStructure | None = None, scheme: PathScheme = PathScheme.LOG_EULER,
):
    arr = contract.as_array(jnp.float32)
    u = simulate_underlier_rows(
        jax.random.PRNGKey(seed), arr, timesteps=timesteps, rows=rows, cols=cols,
        dtype=jnp.float32, scheme=scheme, payoff=VS, term=term,
    )
    u = np.asarray(u, np.float64).ravel()
    df = math.exp(-contract.rate * contract.maturity)
    put = df * np.maximum(contract.strike - u, 0.0)
    call = df * np.maximum(u - contract.strike, 0.0)
    return u, put, call


def _z(sample: np.ndarray, target: float) -> float:
    return float((sample.mean() - target) / (sample.std() / math.sqrt(sample.size)))


def test_variance_config_validation() -> None:
    common = dict(timesteps=4, network_size=8, batches_per_mc_run=2, mc_seed=1)
    # MEAN normalization is allowed for GBM (closed-form E[RV])
    ok = expect_success(
        build_simulation_params(
            **common, payoff=VS, normalization=ForwardNormalization.MEAN
        )
    )
    assert ok.payoff is VS
    # ... but refused for Heston (no closed form under full truncation)
    err = expect_failure(
        build_simulation_params(
            **common, payoff=VS, model=ModelKind.HESTON,
            normalization=ForwardNormalization.MEAN,
        )
    )
    assert isinstance(err, InvalidSimulationParams)
    assert "no closed form" in err.reason
    # a stray barrier level is refused like every non-barrier kind
    stray = build_simulation_params(**common, payoff=VS, barrier_rel=1.5)
    assert isinstance(expect_failure(stray), InvalidSimulationParams)


def test_variance_closed_form_mean_support() -> None:
    from spectralmc_tpu.ops.basket import BasketCombine

    assert has_closed_form_mean(ModelKind.GBM, VS)
    assert has_closed_form_mean(ModelKind.MERTON_JUMP, VS)
    assert not has_closed_form_mean(ModelKind.HESTON, VS)
    assert has_closed_form_mean(
        ModelKind.BASKET_GBM, VS, combine=BasketCombine.GEOMETRIC
    )
    assert not has_closed_form_mean(
        ModelKind.BASKET_GBM, VS, combine=BasketCombine.ARITHMETIC
    )


def test_variance_fair_strike_matches_expected_mean() -> None:
    c = make_contract(vol=0.22, maturity=1.5, rate=0.03, div_yield=0.01)
    eu = float(
        expected_underlier_mean(
            c.as_array(jnp.float64), timesteps=16, payoff=VS, dtype=jnp.float64
        )
    )
    fair = variance_fair_strike(
        c.maturity, c.rate, c.div_yield, c.vol, timesteps=16
    )
    assert eu == pytest.approx(fair, rel=1e-12)
    # and the oracle's internal mean agrees: ATM-forward put == call
    atm = variance_option_price(
        fair, c.maturity, c.rate, c.div_yield, c.vol, timesteps=16
    )
    assert atm.put == pytest.approx(atm.call, rel=1e-12)


@pytest.mark.parametrize("strike", [0.03, 0.06, 0.10])
def test_gbm_variance_matches_ncx2_oracle(strike: float) -> None:
    """Both channels against the exact noncentral-χ² prices — zero
    discretization slop, so plain z-gates at the MC standard error."""
    c = make_contract(strike=strike, vol=0.25, maturity=1.2)
    u, put, call = _mc_channels(c, timesteps=12)
    oracle = variance_option_price(
        strike, c.maturity, c.rate, c.div_yield, c.vol, timesteps=12
    )
    fair = variance_fair_strike(c.maturity, c.rate, c.div_yield, c.vol, timesteps=12)
    assert abs(_z(u, fair)) < 4.0
    assert abs(_z(put, oracle.put)) < 4.0
    assert abs(_z(call, oracle.call)) < 4.0
    # parity is exact sample-by-sample: call − put = df·(RV − K)
    df = math.exp(-c.rate * c.maturity)
    np.testing.assert_allclose(call - put, df * (u - strike), rtol=0, atol=1e-12)


def test_variance_mean_normalization_pins_sample_mean() -> None:
    """MEAN normalization rescales RV so the sample mean hits the exact
    E[RV] — the same contract every other closed-form payoff honors."""
    c = make_contract(vol=0.3, maturity=0.8)
    arr = c.as_array(jnp.float32)
    u = simulate_underlier_rows(
        jax.random.PRNGKey(3), arr, timesteps=8, rows=64, cols=256,
        dtype=jnp.float32, scheme=PathScheme.LOG_EULER, payoff=VS,
    )
    target = expected_underlier_mean(arr, timesteps=8, payoff=VS, dtype=jnp.float32)
    prices = terminal_to_prices(
        u.reshape(-1), arr, normalize=True, dtype=jnp.float32, mean_target=target
    )
    df = float(prices.discount_factor)
    # normalized put/call means reconstruct the normalized underlier mean
    recon = float(jnp.mean(prices.call_payoffs - prices.put_payoffs)) / df + c.strike
    assert recon == pytest.approx(float(target), rel=1e-3)  # f32 reduction order


def test_gbm_variance_term_structure_exact_mean() -> None:
    n = 16
    shape = tuple(float(1.0 + 0.4 * math.sin(2.0 * math.pi * i / n)) for i in range(n))
    term = TermStructure(vol_shape=shape)
    c = make_contract(strike=VAR_STRIKE, vol=0.22, maturity=1.5)
    u, _, _ = _mc_channels(c, timesteps=n, term=term)
    et = float(
        expected_underlier_mean(
            c.as_array(jnp.float64), timesteps=n, payoff=VS, dtype=jnp.float64,
            term=term,
        )
    )
    flat = float(
        expected_underlier_mean(
            c.as_array(jnp.float64), timesteps=n, payoff=VS, dtype=jnp.float64
        )
    )
    assert abs(_z(u, et)) < 4.0
    assert et != pytest.approx(flat, rel=1e-3)  # the curve genuinely moves E[RV]


def test_variance_euler_scheme_continuous_limit() -> None:
    """The reflection-Euler RV converges to the same continuous limit; at a
    moderate grid it must sit within a few percent of the log-Euler mean."""
    c = make_contract(vol=0.2, maturity=1.0, rate=0.02, div_yield=0.0)
    u_le, _, _ = _mc_channels(c, timesteps=32, rows=256, cols=512)
    u_eu, _, _ = _mc_channels(
        c, timesteps=32, rows=256, cols=512, scheme=PathScheme.EULER
    )
    assert u_eu.mean() == pytest.approx(u_le.mean(), rel=0.05)


def test_merton_variance_exact_mean() -> None:
    from spectralmc_tpu.ops.merton import (
        MertonContract,
        merton_expected_underlier_mean,
        simulate_merton_underlier_rows,
    )

    c = MertonContract(
        spot=100.0, strike=VAR_STRIKE, maturity=1.5, rate=0.03, div_yield=0.01,
        vol=0.22, lam=0.7, jump_mean=-0.08, jump_std=0.15,
    )
    arr = c.as_array(jnp.float32)
    u = np.asarray(
        simulate_merton_underlier_rows(
            jax.random.PRNGKey(7), arr, timesteps=16, rows=512, cols=1024,
            dtype=jnp.float32, payoff=VS,
        ),
        np.float64,
    ).ravel()
    em = float(
        merton_expected_underlier_mean(arr, timesteps=16, payoff=VS, dtype=jnp.float64)
    )
    assert abs(_z(u, em)) < 4.0
    # jumps must ADD variance vs the diffusion-only fair strike
    diff_only = variance_fair_strike(
        c.maturity, c.rate, c.div_yield, c.vol, timesteps=16
    )
    assert em > diff_only


def test_heston_variance_tracks_continuous_fair_strike() -> None:
    """No closed form under full truncation — gate against the continuous
    fair strike θ + (v0−θ)(1−e^{−κT})/(κT) with an O(dt) bias allowance."""
    from spectralmc_tpu.ops.heston import HestonContract, simulate_heston_underlier_rows

    c = HestonContract(
        spot=100.0, strike=VAR_STRIKE, maturity=1.5, rate=0.03, div_yield=0.01,
        v0=0.04, kappa=1.5, theta=0.05, xi=0.4, rho=-0.6,
    )
    u = np.asarray(
        simulate_heston_underlier_rows(
            jax.random.PRNGKey(7), c.as_array(jnp.float32), timesteps=64,
            rows=512, cols=512, dtype=jnp.float32, payoff=VS,
        ),
        np.float64,
    ).ravel()
    t, v0, kap, th = c.maturity, c.v0, c.kappa, c.theta
    cont = th + (v0 - th) * (1.0 - math.exp(-kap * t)) / (kap * t)
    assert u.mean() == pytest.approx(cont, rel=0.03)
    assert not has_closed_form_mean(ModelKind.HESTON, VS)


def test_basket_variance_geometric_exact_arithmetic_structural() -> None:
    from spectralmc_tpu.ops.basket import (
        BasketCombine,
        BasketSpec,
        expected_basket_underlier_mean,
        simulate_basket_underlier_rows,
    )

    spec = BasketSpec(
        weights=(0.5, 0.3, 0.2), spot_multipliers=(1.0, 0.9, 1.1),
        vol_multipliers=(1.0, 1.3, 0.7),
        correlation=((1.0, 0.5, 0.2), (0.5, 1.0, 0.4), (0.2, 0.4, 1.0)),
        combine=BasketCombine.GEOMETRIC,
    )
    c = make_contract(strike=0.03, vol=0.22, maturity=1.5)
    arr = c.as_array(jnp.float32)
    u = np.asarray(
        simulate_basket_underlier_rows(
            jax.random.PRNGKey(7), arr, spec=spec, timesteps=12, rows=256, cols=512,
            dtype=jnp.float32, payoff=VS,
        ),
        np.float64,
    ).ravel()
    eb = float(
        expected_basket_underlier_mean(arr, spec, timesteps=12, payoff=VS, dtype=jnp.float64)
    )
    assert abs(_z(u, eb)) < 4.0
    # diversification: basket RV < the weighted single-name RV sum
    single = variance_fair_strike(c.maturity, c.rate, c.div_yield, c.vol, timesteps=12)
    assert eb < single
    spec_a = spec.model_copy(update={"combine": BasketCombine.ARITHMETIC})
    u_a = np.asarray(
        simulate_basket_underlier_rows(
            jax.random.PRNGKey(7), arr, spec=spec_a, timesteps=12, rows=64, cols=128,
            dtype=jnp.float32, payoff=VS,
        ),
        np.float64,
    ).ravel()
    assert np.all(np.isfinite(u_a)) and np.all(u_a > 0)
    assert (
        expected_basket_underlier_mean(arr, spec_a, timesteps=12, payoff=VS, dtype=jnp.float64)
        is None
    )


def test_variance_antithetic_and_qmc_unbiased() -> None:
    c = make_contract(vol=0.25, maturity=1.0)
    arr = c.as_array(jnp.float32)
    fair = variance_fair_strike(c.maturity, c.rate, c.div_yield, c.vol, timesteps=8)
    u_anti = np.asarray(
        simulate_underlier_rows(
            jax.random.PRNGKey(11), arr, timesteps=8, rows=256, cols=512,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER, payoff=VS,
            antithetic_half=128,
        ),
        np.float64,
    ).ravel()
    assert abs(_z(u_anti, fair)) < 4.0
    from spectralmc_tpu.ops.gbm import SamplingKind

    u_qmc = np.asarray(
        simulate_underlier_rows(
            jax.random.PRNGKey(11), arr, timesteps=8, rows=256, cols=512,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER, payoff=VS,
            sampling=SamplingKind.SOBOL_BB, mc_seed=5,
        ),
        np.float64,
    ).ravel()
    # the net stratifies the increments; RV is a smooth functional, so the
    # QMC mean should land much tighter than 4 pseudo-standard-errors
    assert abs(_z(u_qmc, fair)) < 4.0


def test_variance_row_offset_shard_stability() -> None:
    c = make_contract(vol=0.25).as_array(jnp.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(
        timesteps=6, cols=64, dtype=jnp.float32, scheme=PathScheme.LOG_EULER, payoff=VS
    )
    full = simulate_underlier_rows(key, c, rows=16, **kw)
    top = simulate_underlier_rows(key, c, rows=8, row_offset=0, **kw)
    bot = simulate_underlier_rows(key, c, rows=8, row_offset=8, **kw)
    np.testing.assert_array_equal(np.asarray(full), np.vstack([top, bot]))


def test_variance_pallas_interpret_zero_bit_replay() -> None:
    """Zero-bit PRNG replay pins the flat kernel's pair-step algebra: with
    u1 = 2⁻²⁵ and u2 = 0 every pair contributes
    2a² + b²·r² + 2√2·a·b·r·sin(π/4) deterministically."""
    from spectralmc_tpu.ops.gbm_pallas import simulate_underlier_rows_pallas

    c = make_contract(vol=0.25)
    arr = c.as_array(jnp.float32)
    with zero_bits():
        rows = simulate_underlier_rows_pallas(
            jax.random.PRNGKey(1), arr, timesteps=8, rows=8, cols=128,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER, payoff=VS,
            interpret=True,
        )
    t = np.asarray(rows)
    assert t.shape == (8, 128) and np.all(np.isfinite(t)) and np.all(t > 0)
    assert np.allclose(t, t[0, 0])  # zero-bit RNG → identical paths
    dt = c.maturity / 8
    a = (c.rate - c.div_yield - 0.5 * c.vol**2) * dt
    b = c.vol * math.sqrt(dt)
    x = -2.0 * math.log(np.float32(2.0**-25))
    r = math.sqrt(x)
    pair = 2.0 * a * a + b * b * x + 2.0 * math.sqrt(2.0) * a * b * r * math.sin(math.pi / 4.0)
    expected = 4 * pair / c.maturity
    assert t[0, 0] == pytest.approx(expected, rel=1e-4)


def test_variance_pallas_interpret_all_dynamics_structural() -> None:
    """Every family kernel's variance branch runs under the interpreter and
    yields a positive uniform zero-bit skeleton."""
    from spectralmc_tpu.ops.basket import BasketCombine, BasketSpec
    from spectralmc_tpu.ops.gbm_pallas import (
        simulate_basket_underlier_rows_pallas,
        simulate_heston_underlier_rows_pallas,
        simulate_merton_underlier_rows_pallas,
        simulate_underlier_rows_pallas,
    )

    key = jax.random.PRNGKey(1)
    c6 = make_contract(vol=0.25).as_array(jnp.float32)
    ch = jnp.array([100.0, VAR_STRIKE, 1.0, 0.03, 0.01, 0.04, 1.5, 0.05, 0.4, -0.6], jnp.float32)
    cm = jnp.array([100.0, VAR_STRIKE, 1.0, 0.03, 0.01, 0.22, 0.7, -0.08, 0.15], jnp.float32)
    spec = BasketSpec(
        weights=(0.6, 0.4), spot_multipliers=(1.0, 0.9), vol_multipliers=(1.0, 1.2),
        correlation=((1.0, 0.3), (0.3, 1.0)), combine=BasketCombine.GEOMETRIC,
    )
    n_shape = tuple(1.0 + 0.2 * math.sin(i) for i in range(8))
    term = TermStructure(vol_shape=n_shape)
    with zero_bits():
        outs = {
            "gbm_odd": simulate_underlier_rows_pallas(
                key, c6, timesteps=7, rows=8, cols=128, dtype=jnp.float32,
                scheme=PathScheme.LOG_EULER, payoff=VS, interpret=True,
            ),
            "gbm_euler": simulate_underlier_rows_pallas(
                key, c6, timesteps=8, rows=8, cols=128, dtype=jnp.float32,
                scheme=PathScheme.EULER, payoff=VS, interpret=True,
            ),
            "gbm_term": simulate_underlier_rows_pallas(
                key, c6, timesteps=8, rows=8, cols=128, dtype=jnp.float32,
                scheme=PathScheme.LOG_EULER, payoff=VS, term=term, interpret=True,
            ),
            "heston": simulate_heston_underlier_rows_pallas(
                key, ch, timesteps=8, rows=8, cols=128, dtype=jnp.float32,
                payoff=VS, interpret=True,
            ),
            "merton": simulate_merton_underlier_rows_pallas(
                key, cm, timesteps=8, rows=8, cols=128, dtype=jnp.float32,
                payoff=VS, interpret=True,
            ),
            "basket": simulate_basket_underlier_rows_pallas(
                key, c6, spec=spec, timesteps=8, rows=8, cols=128, dtype=jnp.float32,
                payoff=VS, interpret=True,
            ),
        }
    for name, out in outs.items():
        t = np.asarray(out)
        assert t.shape == (8, 128), name
        assert np.all(np.isfinite(t)) and np.all(t > 0), name
        assert np.allclose(t, t[0, 0]), name


def test_variance_antithetic_pallas_interpret_halves_differ() -> None:
    """Antithetic pairing (global row pairs 2k, 2k+1) flips only the cross
    term of the pair contribution: even and odd rows are distinct but both
    deterministic."""
    from spectralmc_tpu.ops.gbm_pallas import simulate_underlier_rows_pallas

    c = make_contract(vol=0.25).as_array(jnp.float32)
    with zero_bits():
        rows = simulate_underlier_rows_pallas(
            jax.random.PRNGKey(1), c, timesteps=8, rows=8, cols=128,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER, payoff=VS,
            antithetic_half=4, interpret=True,
        )
    t = np.asarray(rows)
    assert np.allclose(t[0::2], t[0, 0]) and np.allclose(t[1::2], t[1, 0])
    assert t[0, 0] != pytest.approx(t[1, 0])


def test_mc_greeks_variance_ipa_vega_and_zero_delta() -> None:
    """IPA vega against central FD under common random numbers; the pathwise
    delta is identically zero under log-Euler (RV is spot-free) — which IS
    the true model delta of a variance swap."""
    from spectralmc_tpu.ops.greeks import OptionSide, make_mc_price_fn, mc_greeks

    sim = make_simulation_params(
        timesteps=8, network_size=128, batches_per_mc_run=64, payoff=VS,
        normalization=ForwardNormalization.NONE,
    )
    c = make_contract(strike=VAR_STRIKE, vol=0.25)
    g = mc_greeks(sim, c, option=OptionSide.CALL, draw_index=3)
    assert g.by_field["spot"] == 0.0
    price_fn = make_mc_price_fn(sim, option=OptionSide.CALL)
    arr = c.as_array(jnp.float32)
    h = 1e-3
    up = float(price_fn(jnp.asarray(3, jnp.uint32), arr.at[5].add(h)))
    dn = float(price_fn(jnp.asarray(3, jnp.uint32), arr.at[5].add(-h)))
    fd_vega = (up - dn) / (2 * h)
    assert g.by_field["vol"] == pytest.approx(fd_vega, rel=5e-2)
    assert g.by_field["vol"] > 0.0  # a variance cap is long vol


def test_term_bucket_greeks_variance_ladder() -> None:
    """The curve ladder supports VARIANCE_SWAP: bucket vegas are positive
    (RV is increasing in every vol bucket) and one bucket matches FD."""
    from spectralmc_tpu.ops.greeks import OptionSide, term_bucket_greeks

    n = 8
    shape = tuple(1.0 + 0.1 * math.sin(i) for i in range(n))
    sim = make_simulation_params(
        timesteps=n, network_size=128, batches_per_mc_run=32, payoff=VS,
        normalization=ForwardNormalization.NONE,
        term=TermStructure(vol_shape=shape),
    )
    c = make_contract(strike=0.03, vol=0.25)
    g = term_bucket_greeks(sim, c, option=OptionSide.CALL, draw_index=2)
    assert len(g.vega_buckets) == n
    assert all(v > 0.0 for v in g.vega_buckets)
    # FD check of bucket 3 via a bumped TermStructure
    h = 1e-3
    bumped_up = list(shape)
    bumped_up[3] += h
    bumped_dn = list(shape)
    bumped_dn[3] -= h
    prices = []
    for s in (tuple(bumped_up), tuple(bumped_dn)):
        sim_b = make_simulation_params(
            timesteps=n, network_size=128, batches_per_mc_run=32, payoff=VS,
            normalization=ForwardNormalization.NONE, term=TermStructure(vol_shape=s),
        )
        prices.append(
            term_bucket_greeks(sim_b, c, option=OptionSide.CALL, draw_index=2).price
        )
    fd = (prices[0] - prices[1]) / (2 * h)
    assert g.vega_buckets[3] == pytest.approx(fd, rel=5e-2)


def test_variance_proto_round_trip() -> None:
    from spectralmc_tpu.serialization.converters import (
        sim_params_from_proto,
        sim_params_to_proto,
    )

    sim = make_simulation_params(payoff=VS, normalization=ForwardNormalization.MEAN)
    back = expect_success(sim_params_from_proto(sim_params_to_proto(sim)))
    assert back == sim
    assert back.payoff is VS


def test_variance_pricer_trains_resumes_and_prices_with_parity() -> None:
    """Trainer over the variance payoff with variance-unit strike bounds:
    training runs, resume is bit-exact, and the call channel rides the
    closed-form parity."""
    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
    from spectralmc_tpu.ops.sobol import BoundSpec
    from spectralmc_tpu.training.trainer import (
        GbmCVNNPricer,
        GbmCVNNPricerConfig,
        build_training_config,
    )

    bounds = {
        "spot": BoundSpec(lower=80.0, upper=120.0),
        "strike": BoundSpec(lower=0.02, upper=0.10),  # variance units
        "maturity": BoundSpec(lower=0.5, upper=2.0),
        "rate": BoundSpec(lower=0.0, upper=0.08),
        "div_yield": BoundSpec(lower=0.0, upper=0.04),
        "vol": BoundSpec(lower=0.15, upper=0.40),
    }
    sim = make_simulation_params(
        timesteps=4, network_size=32, batches_per_mc_run=8, payoff=VS,
        normalization=ForwardNormalization.MEAN,
    )
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
    resumed = expect_success(GbmCVNNPricer.create(snap))
    r1 = expect_success(pricer.train(tc))
    r2 = expect_success(resumed.train(tc))
    np.testing.assert_array_equal(r1.losses, r2.losses)
    contracts = [make_contract(strike=0.04), make_contract(strike=0.08)]
    pred = resumed.predict_price(contracts)
    assert np.all(np.isfinite(pred.put))
    df = np.exp(-np.array([c.rate * c.maturity for c in contracts]))
    for i, c in enumerate(contracts):
        eu = float(
            expected_underlier_mean(
                c.as_array(jnp.float64), timesteps=4, payoff=VS, dtype=jnp.float64
            )
        )
        assert pred.call[i] == pytest.approx(
            pred.put[i] + (eu - c.strike) * df[i], rel=1e-4, abs=1e-5
        )
