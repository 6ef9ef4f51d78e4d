"""Quasi-Monte-Carlo path sampling (ops/qmc.py + SamplingKind wiring).

Extension beyond the reference (its path normals are always pseudo-random,
async_normals.py:213-217). Gates: exact Brownian-bridge orthogonality, shard
stability of the Sobol point indexing, the measured variance-reduction win
over the pseudo stream, engine/proto/trainer integration, and the refusal
matrix for combinations the estimator does not define.
"""

from __future__ import annotations

import math
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spectralmc_tpu.core.result import Failure, Success
from spectralmc_tpu.ops.analytic import black_scholes_price, geometric_asian_price
from spectralmc_tpu.ops.gbm import (
    BlackScholes,
    PathScheme,
    PayoffKind,
    SamplingKind,
    SimImplementation,
    build_simulation_params,
    resolve_implementation,
    simulate_underlier_rows,
    terminal_to_prices,
)
from spectralmc_tpu.ops.greeks import OptionSide, analytic_greeks, mc_greeks
from spectralmc_tpu.ops.qmc import (
    brownian_bridge_matrix,
    qmc_effective_normals,
    qmc_sobol_dims,
)
from spectralmc_tpu.serialization.converters import (
    sim_params_from_proto,
    sim_params_to_proto,
)
from tests.helpers import expect_failure, expect_success
from tests.helpers.factories import make_contract, make_simulation_params

CONTRACT = make_contract()  # spot=strike=100, T=1, r=3%, q=1%, vol=25%


# --------------------------------------------------------------------------
# Brownian-bridge map
# --------------------------------------------------------------------------


@pytest.mark.parametrize("timesteps", [1, 2, 3, 8, 16, 17, 64, 100])
def test_bb_matrix_is_exactly_orthogonal(timesteps: int) -> None:
    """Unit-step Brownian increments are iid N(0,1), so the bridge map must
    be an orthogonal matrix — the QMC normals are then a pure rotation of
    iid normals (distribution-exact to plug into the unchanged scan)."""
    m = brownian_bridge_matrix(timesteps)
    assert m.shape == (timesteps, timesteps)
    err = np.abs(m @ m.T - np.eye(timesteps)).max()
    assert err < 1e-10, f"M M^T deviates from I by {err}"


def test_bb_variance_ordering_terminal_first() -> None:
    """z_0 alone determines the terminal value (the bridge's whole point:
    the lowest Sobol dimension — the best-distributed one — carries the
    largest variance share)."""
    t = 16
    m = brownian_bridge_matrix(t)
    w = np.cumsum(m, axis=0)  # w[i] = coefficients of W_{i+1}
    assert w[-1, 0] == pytest.approx(np.sqrt(t), rel=1e-12)
    assert np.abs(w[-1, 1:]).max() < 1e-12
    # the path AVERAGE (the Asian functional) loads mostly on the coarse
    # dimensions: z_0 explains the dominant share, the finest level a sliver
    c = w.mean(axis=0)  # average of W_1..W_T as a linear functional of z
    share = c**2 / (c**2).sum()
    assert share[0] > 0.5
    assert share[0] > 20 * share[-1]


def test_qmc_sobol_dims_caps_at_table_size() -> None:
    assert qmc_sobol_dims(16) == 16
    assert qmc_sobol_dims(64) == 64
    assert qmc_sobol_dims(200) == 64


# --------------------------------------------------------------------------
# Effective normals
# --------------------------------------------------------------------------


def test_effective_normals_shard_stable_and_deterministic() -> None:
    key = jax.random.PRNGKey(11)
    kw = dict(timesteps=8, cols=128, dtype=jnp.float32, mc_seed=5)
    full = qmc_effective_normals(key, rows=8, **kw)
    lo = qmc_effective_normals(key, rows=4, row_offset=0, **kw)
    hi = qmc_effective_normals(key, rows=4, row_offset=4, **kw)
    assert (jnp.concatenate([lo, hi], axis=1) == full).all()
    again = qmc_effective_normals(key, rows=8, **kw)
    assert (again == full).all()
    other = qmc_effective_normals(jax.random.fold_in(key, 1), rows=8, **kw)
    assert not (other == full).all()


@pytest.mark.parametrize("timesteps", [16, 100])  # 100 exercises the padded tail
def test_effective_normals_moments(timesteps: int) -> None:
    z = qmc_effective_normals(
        jax.random.PRNGKey(3),
        timesteps=timesteps,
        rows=8,
        cols=512,
        dtype=jnp.float32,
        mc_seed=9,
    )
    assert z.shape == (timesteps, 8, 512)
    assert float(jnp.abs(jnp.mean(z))) < 0.02
    assert float(jnp.std(z)) == pytest.approx(1.0, abs=0.02)
    # per-step marginals stay unit-variance (the rotation preserves them)
    step_std = jnp.std(z.reshape(timesteps, -1), axis=1)
    assert float(jnp.abs(step_std - 1.0).max()) < 0.1


# --------------------------------------------------------------------------
# The variance-reduction win (the reason this module exists)
# --------------------------------------------------------------------------


def _price_replicates(sampling: SamplingKind, payoff: PayoffKind, reps: int = 8):
    """Discounted mean call payoff over `reps` independent draws, 4096 paths."""
    dtype = jnp.float32
    contract = CONTRACT.as_array(dtype)
    base = jax.random.PRNGKey(77)
    out = []
    for i in range(reps):
        rows = simulate_underlier_rows(
            jax.random.fold_in(base, i),
            contract,
            timesteps=16,
            rows=16,
            cols=256,
            dtype=dtype,
            scheme=expect_success(
                build_simulation_params(
                    timesteps=16, network_size=256, batches_per_mc_run=16, mc_seed=1
                )
            ).scheme,
            payoff=payoff,
            sampling=sampling,
            mc_seed=31,
        )
        prices = terminal_to_prices(rows.reshape(-1), contract, normalize=False, dtype=dtype)
        out.append(float(jnp.mean(prices.call_payoffs)))
    return np.array(out)


def test_qmc_beats_pseudo_on_vanilla_rmse() -> None:
    """At an equal 4096-path budget the RQMC estimator's RMSE must come in
    far below the pseudo stream's (measured ~50x at these sizes; gated
    conservatively at 4x so scramble-seed luck cannot flake the suite)."""
    truth = float(black_scholes_price(100.0, 100.0, 1.0, 0.03, 0.01, 0.25).call)
    qmc = _price_replicates(SamplingKind.SOBOL_BB, PayoffKind.TERMINAL)
    mc = _price_replicates(SamplingKind.PSEUDO, PayoffKind.TERMINAL)
    rmse_q = float(np.sqrt(np.mean((qmc - truth) ** 2)))
    rmse_p = float(np.sqrt(np.mean((mc - truth) ** 2)))
    assert rmse_q < rmse_p / 4.0, f"qmc rmse {rmse_q} vs pseudo {rmse_p}"


def test_qmc_beats_pseudo_on_asian_rmse() -> None:
    """Path-dependent check: geometric-Asian payoff vs its closed form under
    the same discrete grid. The average depends on every timestep, so this
    also exercises the full bridge (not just the terminal dimension)."""
    truth = float(
        geometric_asian_price(100.0, 100.0, 1.0, 0.03, 0.01, 0.25, timesteps=16).call
    )
    qmc = _price_replicates(SamplingKind.SOBOL_BB, PayoffKind.ASIAN_GEOMETRIC)
    mc = _price_replicates(SamplingKind.PSEUDO, PayoffKind.ASIAN_GEOMETRIC)
    rmse_q = float(np.sqrt(np.mean((qmc - truth) ** 2)))
    rmse_p = float(np.sqrt(np.mean((mc - truth) ** 2)))
    assert rmse_q < rmse_p / 3.0, f"qmc rmse {rmse_q} vs pseudo {rmse_p}"


# --------------------------------------------------------------------------
# Engine / config / proto integration
# --------------------------------------------------------------------------


def _qmc_params(**overrides: object):
    merged: dict[str, object] = dict(
        timesteps=16,
        network_size=256,
        batches_per_mc_run=16,
        sampling=SamplingKind.SOBOL_BB,
    )
    merged.update(overrides)
    return make_simulation_params(**merged)


def test_engine_qmc_price_accuracy_and_bit_exact_replay() -> None:
    params = _qmc_params()
    truth = black_scholes_price(100.0, 100.0, 1.0, 0.03, 0.01, 0.25)
    hp, advanced = BlackScholes(params).price_to_host(CONTRACT)
    assert hp.put == pytest.approx(float(truth.put), abs=0.05)
    assert hp.call == pytest.approx(float(truth.call), abs=0.05)
    assert advanced.params.skip == params.skip + 1
    # same (seed, skip) -> bit-identical price (the resume contract)
    hp2, _ = BlackScholes(params).price_to_host(CONTRACT)
    assert hp2.put == hp.put and hp2.call == hp.call
    # advancing the skip re-randomizes the digital shift -> different estimate
    hp3, _ = advanced.price_to_host(CONTRACT)
    assert hp3.put != hp.put


def test_qmc_params_proto_round_trip() -> None:
    params = _qmc_params()
    decoded = expect_success(sim_params_from_proto(sim_params_to_proto(params)))
    assert decoded == params
    assert decoded.sampling == SamplingKind.SOBOL_BB


def test_pre_qmc_checkpoint_decodes_to_pseudo() -> None:
    proto = sim_params_to_proto(make_simulation_params())
    proto.sampling = ""  # a checkpoint written before the field existed
    decoded = expect_success(sim_params_from_proto(proto))
    assert decoded.sampling == SamplingKind.PSEUDO


def test_resolve_implementation_routes_qmc_to_xla() -> None:
    params = _qmc_params(implementation=SimImplementation.PALLAS)
    assert resolve_implementation(params) == SimImplementation.XLA


@pytest.mark.parametrize(
    "overrides",
    [
        dict(antithetic=True),
        dict(payoff="american_put"),
    ],
)
def test_qmc_refusal_matrix(overrides: dict) -> None:
    err = expect_failure(
        build_simulation_params(
            timesteps=16,
            network_size=256,
            batches_per_mc_run=16,
            mc_seed=7,
            sampling=SamplingKind.SOBOL_BB,
            **overrides,
        )
    )
    assert err is not None


def test_qmc_barrier_payoff_prices_near_oracle() -> None:
    """Knockouts run under QMC too (the running extreme consumes the whole
    bridge); gate vs the discrete-monitoring density-propagation oracle."""
    from spectralmc_tpu.ops.analytic import discrete_barrier_price

    params = _qmc_params(
        payoff=PayoffKind.BARRIER_UP_OUT,
        barrier_rel=1.4,
        normalization="none",
        batches_per_mc_run=64,
    )
    truth = discrete_barrier_price(
        100.0,
        100.0,
        1.0,
        0.03,
        0.01,
        0.25,
        barrier_rel=1.4,
        up=True,
        timesteps=16,
    )
    hp, _ = BlackScholes(params).price_to_host(CONTRACT)
    assert hp.call == pytest.approx(float(truth.call), abs=max(0.03 * float(truth.call), 0.05))


# --------------------------------------------------------------------------
# Multi-factor QMC (Heston, baskets)
# --------------------------------------------------------------------------


def test_multi_factor_normals_shapes_and_single_factor_slice() -> None:
    from spectralmc_tpu.ops.qmc import qmc_effective_normals_multi

    key = jax.random.PRNGKey(4)
    kw = dict(timesteps=8, rows=4, cols=64, dtype=jnp.float32, mc_seed=9)
    z2 = qmc_effective_normals_multi(key, factors=2, **kw)
    assert z2.shape == (8, 2, 4, 64)
    # factors=1 is bit-exactly the single-factor generator
    z1 = qmc_effective_normals_multi(key, factors=1, **kw)
    zs = qmc_effective_normals(key, **kw)
    assert (z1[:, 0] == zs).all()
    # shard stability holds for the multi-factor net too
    lo = qmc_effective_normals_multi(key, factors=2, timesteps=8, rows=2, cols=64,
                                     dtype=jnp.float32, mc_seed=9, row_offset=0)
    hi = qmc_effective_normals_multi(key, factors=2, timesteps=8, rows=2, cols=64,
                                     dtype=jnp.float32, mc_seed=9, row_offset=2)
    assert (jnp.concatenate([lo, hi], axis=2) == z2).all()
    # factors are decorrelated (the interleaved dims are distinct)
    flat = np.asarray(z2.reshape(8 * 2, -1))
    c = np.corrcoef(np.asarray(z2[:, 0].reshape(8, -1)), np.asarray(z2[:, 1].reshape(8, -1)))
    assert np.abs(c[:8, 8:]).max() < 0.1, "cross-factor correlation leaked"
    del flat


def test_heston_qmc_variance_reduction_and_accuracy() -> None:
    """Heston under 2-factor QMC: replicate spread collapses vs pseudo (the
    oracle-free gate — the Euler bias is common to both streams), and the
    estimate stays within bias+SE distance of the semi-analytic price."""
    from spectralmc_tpu.ops.heston import HestonContract, heston_call_price
    from spectralmc_tpu.ops.heston import simulate_heston_underlier_rows

    c = HestonContract(
        spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
        v0=0.04, kappa=1.5, theta=0.04, xi=0.4, rho=-0.6,
    )
    dtype = jnp.float32
    arr = c.as_array(dtype)
    base = jax.random.PRNGKey(55)

    def estimates(sampling: SamplingKind) -> np.ndarray:
        out = []
        for i in range(8):
            rows = simulate_heston_underlier_rows(
                jax.random.fold_in(base, i),
                arr,
                timesteps=16,
                rows=16,
                cols=256,
                dtype=dtype,
                payoff=PayoffKind.TERMINAL,
                sampling=sampling if sampling == SamplingKind.SOBOL_BB else None,
                mc_seed=13,
            )
            prices = terminal_to_prices(rows.reshape(-1), arr, normalize=False, dtype=dtype)
            out.append(float(jnp.mean(prices.call_payoffs)))
        return np.array(out)

    qmc = estimates(SamplingKind.SOBOL_BB)
    mc = estimates(SamplingKind.PSEUDO)
    assert qmc.std() < mc.std() / 2.5, f"qmc std {qmc.std()} vs pseudo {mc.std()}"
    truth, _ = heston_call_price(
        spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
        v0=0.04, kappa=1.5, theta=0.04, xi=0.4, rho=-0.6,
    )
    # 16-step full-truncation Euler bias dominates the QMC noise here; the
    # band is bias-width, the point is the mean is NOT drifting off
    assert abs(qmc.mean() - truth) < 0.05 * truth


def test_basket_qmc_beats_pseudo_on_geometric_oracle() -> None:
    """Geometric basket has an EXACT discrete-grid closed form — gate the
    n_assets-factor bridge end to end on RMSE like the GBM vanilla test."""
    from spectralmc_tpu.ops.analytic import geometric_basket_price
    from spectralmc_tpu.ops.basket import (
        BasketCombine,
        build_basket_spec,
        simulate_basket_underlier_rows,
    )

    spec = expect_success(
        build_basket_spec(
            weights=(0.5, 0.3, 0.2),
            correlation=(
                (1.0, 0.4, 0.2),
                (0.4, 1.0, 0.3),
                (0.2, 0.3, 1.0),
            ),
            combine=BasketCombine.GEOMETRIC,
        )
    )
    dtype = jnp.float32
    arr = CONTRACT.as_array(dtype)
    truth = float(
        geometric_basket_price(
            100.0, 100.0, 1.0, 0.03, 0.01, 0.25, spec=spec
        ).call
    )
    base = jax.random.PRNGKey(99)

    def estimates(sampling) -> np.ndarray:
        out = []
        for i in range(8):
            rows = simulate_basket_underlier_rows(
                jax.random.fold_in(base, i),
                arr,
                spec=spec,
                timesteps=8,
                rows=16,
                cols=256,
                dtype=dtype,
                payoff=PayoffKind.TERMINAL,
                sampling=sampling,
                mc_seed=17,
            )
            prices = terminal_to_prices(rows.reshape(-1), arr, normalize=False, dtype=dtype)
            out.append(float(jnp.mean(prices.call_payoffs)))
        return np.array(out)

    qmc = estimates(SamplingKind.SOBOL_BB)
    mc = estimates(None)
    rmse_q = float(np.sqrt(np.mean((qmc - truth) ** 2)))
    rmse_p = float(np.sqrt(np.mean((mc - truth) ** 2)))
    assert rmse_q < rmse_p / 3.0, f"qmc rmse {rmse_q} vs pseudo {rmse_p}"


def test_heston_and_basket_qmc_configs_build() -> None:
    """build_simulation_params accepts QMC for all three model families."""
    from spectralmc_tpu.ops.basket import build_basket_spec

    heston = build_simulation_params(
        timesteps=8, network_size=64, batches_per_mc_run=8, mc_seed=3,
        model="heston", sampling=SamplingKind.SOBOL_BB,
    )
    assert isinstance(heston, Success)
    spec = expect_success(
        build_basket_spec(weights=(0.5, 0.5), correlation=((1.0, 0.3), (0.3, 1.0)))
    )
    basket = build_simulation_params(
        timesteps=8, network_size=64, batches_per_mc_run=8, mc_seed=3,
        model="basket_gbm", basket=spec, sampling=SamplingKind.SOBOL_BB,
    )
    assert isinstance(basket, Success)
    assert resolve_implementation(
        basket.value.model_copy(update={"implementation": SimImplementation.PALLAS})
    ) == SimImplementation.XLA


# --------------------------------------------------------------------------
# Greeks through the QMC stream
# --------------------------------------------------------------------------


def test_qmc_ipa_greeks_match_analytic() -> None:
    """Pathwise IPA differentiates straight through the bridge matmul (the
    Sobol bits are contract-independent) — and inherits the variance
    reduction, so the tolerance is TIGHTER than the pseudo test's 3%."""
    sim = _qmc_params(batches_per_mc_run=64)  # 16k paths
    mc = mc_greeks(sim, CONTRACT, option=OptionSide.CALL)
    oracle = analytic_greeks(CONTRACT, option=OptionSide.CALL)
    assert mc.engine == SimImplementation.XLA
    assert mc.price == pytest.approx(oracle.price, rel=0.01, abs=0.005)
    for field in ("spot", "strike", "maturity", "rate", "div_yield", "vol"):
        want = oracle.by_field[field]
        assert mc.by_field[field] == pytest.approx(
            want, abs=max(0.015 * abs(want), 0.002)
        ), field


# --------------------------------------------------------------------------
# Trainer integration
# --------------------------------------------------------------------------


def test_trainer_qmc_snapshot_resume_bit_exact() -> None:
    """QMC training is deterministic and resumable: snapshot mid-run, resume,
    and the final weights equal continuous training bit-for-bit (the
    digital shift is a pure function of (seed, draw) — no hidden state)."""
    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
    from spectralmc_tpu.training.trainer import (
        GbmCVNNPricer,
        GbmCVNNPricerConfig,
        build_training_config,
    )
    from tests.helpers.factories import CONTRACT_BOUNDS

    sim = make_simulation_params(
        timesteps=4,
        network_size=16,
        batches_per_mc_run=4,
        sampling=SamplingKind.SOBOL_BB,
    )
    cvnn = expect_success(
        build_cvnn_config(
            layers=[LinearCfg(width=16, activation=Activation.MODRELU)],
            seed=3,
            precision=sim.precision,
        )
    )
    cfg = GbmCVNNPricerConfig(sim=sim, bounds=CONTRACT_BOUNDS, cvnn=cvnn)
    training = expect_success(
        build_training_config(num_batches=4, batch_size=4, learning_rate=1e-3)
    )
    half = expect_success(
        build_training_config(num_batches=2, batch_size=4, learning_rate=1e-3)
    )

    continuous = expect_success(GbmCVNNPricer.create(cfg))
    r_cont = expect_success(continuous.train(training))

    first = expect_success(GbmCVNNPricer.create(cfg))
    expect_success(first.train(half))
    snap = first.snapshot()
    assert snap.sim.sampling == SamplingKind.SOBOL_BB
    resumed = expect_success(GbmCVNNPricer.create(snap))
    r_res = expect_success(resumed.train(half))

    a = r_cont.updated_config.model_state
    b = r_res.updated_config.model_state
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert r_cont.losses[-1] == r_res.losses[-1]


def test_effect_path_qmc_matches_engine() -> None:
    """The SimulatePaths interpreter consumes the same QMC stream as the
    direct engine (bit-exact), and refuses the undefined combinations."""
    import asyncio

    from spectralmc_tpu.effects.interpreter import SpectralMCInterpreter
    from spectralmc_tpu.effects.types import SimulatePaths

    params = _qmc_params()
    prices, _ = BlackScholes(params).price(CONTRACT)

    interp = SpectralMCInterpreter.create()
    effect = SimulatePaths(
        spot=CONTRACT.spot,
        strike=CONTRACT.strike,
        maturity=CONTRACT.maturity,
        rate=CONTRACT.rate,
        div_yield=CONTRACT.div_yield,
        vol=CONTRACT.vol,
        timesteps=params.timesteps,
        batches=params.batches_per_mc_run,
        network_size=params.network_size,
        seed=params.mc_seed,
        counter=params.skip,
        normalization=params.normalization.value,
        sampling="sobol_bb",
        out_id="qmc_payoffs",
    )
    result = asyncio.run(interp.interpret(effect))
    assert isinstance(result, Success), result
    stored = expect_success(interp.registry.get_array("qmc_payoffs"))
    assert np.array_equal(np.asarray(stored), np.asarray(prices.put_payoffs))

    for bad in (
        SimulatePaths(payoff="american_put", sampling="sobol_bb", timesteps=4, batches=4, network_size=8, normalization="none"),
        SimulatePaths(antithetic=True, sampling="sobol_bb", timesteps=4, batches=4, network_size=8, normalization="none"),
        SimulatePaths(sampling="not_a_kind", timesteps=4, batches=4, network_size=8, normalization="none"),
    ):
        refused = asyncio.run(interp.interpret(bad))
        assert isinstance(refused, Failure), bad


def test_terminal_shortcut_matches_full_path_scan() -> None:
    """The flat log-Euler terminal shortcut (gbm.simulate_terminal_rows'
    SOBOL_BB branch) must equal the full bridge+scan walk path for path:
    sum_t increments == sqrt(T)*z_0 exactly in real arithmetic, so the two
    engines may differ only by float summation order (~ulps on log S_T)."""
    import math

    from spectralmc_tpu.ops.gbm import PathScheme, SamplingKind, simulate_terminal_rows
    from spectralmc_tpu.ops.qmc import qmc_effective_normals, qmc_terminal_normals

    key = jax.random.PRNGKey(21)
    T, R, C = 16, 64, 256
    contract = jnp.array([100.0, 100.0, 1.0, 0.03, 0.01, 0.25], jnp.float32)

    got = np.asarray(
        simulate_terminal_rows(
            key, contract, timesteps=T, rows=R, cols=C, dtype=jnp.float32,
            scheme=PathScheme.LOG_EULER, sampling=SamplingKind.SOBOL_BB, mc_seed=9,
        ),
        dtype=np.float64,
    )
    # reference: the explicit scan over the full effective-normal tensor
    z = np.asarray(
        qmc_effective_normals(
            key, timesteps=T, rows=R, cols=C, dtype=jnp.float32, mc_seed=9
        ),
        dtype=np.float64,
    )
    dt = 1.0 / T
    drift = (0.03 - 0.01 - 0.5 * 0.25**2) * dt
    want = 100.0 * np.exp(T * drift + 0.25 * math.sqrt(dt) * z.sum(axis=0))
    np.testing.assert_allclose(got, want, rtol=3e-5)

    # the shortcut's z_0 IS dimension 0 of the full generator's stream:
    # sum_t z[t] = sqrt(T) * z_0 by bridge orthogonality
    z0 = np.asarray(
        qmc_terminal_normals(
            key, timesteps=T, rows=R, cols=C, dtype=jnp.float32, mc_seed=9
        )[0],
        dtype=np.float64,
    )
    np.testing.assert_allclose(z.sum(axis=0), math.sqrt(T) * z0, atol=2e-5)


def test_inv_cdf_top_bucket_is_finite() -> None:
    """Round-4 bug regression: ``top24 + 0.5`` needs 25 mantissa bits at the
    maximal bucket and rounded u up to exactly 1.0, so ``erf_inv`` returned
    ``inf`` — one poisoned draw per ~16.8M, near-certain at production path
    counts (found by the fused-kernel bit-identity probe at 64x2M). The
    guard remaps ONLY that bucket to its intended argument 1 - 2^-24."""
    from spectralmc_tpu.ops.qmc import _inv_cdf

    # every low-byte variant of the max bucket, plus the extremes
    bits = jnp.asarray(
        [0xFFFFFF00, 0xFFFFFFFF, 0xFFFFFFB1, 0x00000000, 0x000000FF],
        dtype=jnp.uint32,
    )
    z = np.asarray(_inv_cdf(bits), dtype=np.float64)
    assert np.isfinite(z).all(), z
    want_top = math.sqrt(2.0) * float(
        jax.lax.erf_inv(jnp.float32(1.0 - 2.0**-24))
    )
    np.testing.assert_allclose(z[:3], want_top, rtol=1e-6)
    # bottom bucket is symmetric-safe by construction (0 + 0.5 is exact):
    # its value is the true erf_inv(-(1 - 2^-24)), NOT -inf
    np.testing.assert_allclose(z[3:], -want_top, rtol=1e-6)


def test_inv_cdf_other_buckets_unchanged_and_finite() -> None:
    """The guard must not perturb any non-maximal bucket: spot-check the
    neighbors of both extremes and a mid-range band against the unguarded
    formula, and assert finiteness across the whole sweep."""
    from spectralmc_tpu.ops.qmc import _inv_cdf

    top = np.concatenate(
        [np.arange(0, 1000), np.arange(2**24 - 1000, 2**24 - 1), [2**23]]
    ).astype(np.uint64)
    bits = jnp.asarray((top << 8).astype(np.uint32))
    z = np.asarray(_inv_cdf(bits))
    assert np.isfinite(z).all()
    u = (top.astype(np.float32) + np.float32(0.5)) * np.float32(2.0**-24)
    x = np.float32(2.0) * u - np.float32(1.0)
    want = np.asarray(
        jnp.float32(1.4142135623730951) * jax.lax.erf_inv(jnp.asarray(x))
    )
    np.testing.assert_array_equal(z.view(np.uint32), want.view(np.uint32))


# --------------------------------------------------------------------------
# The XLA generator's own pieces: scrambled-Sobol bits -> inverse CDF ->
# Brownian-bridge contraction, against the public generator
# --------------------------------------------------------------------------

PIPELINE_SHAPES = [
    # (timesteps, factors, rows, cols, row_offset)
    (16, 1, 64, 128, 0),
    (64, 1, 16, 256, 0),
    (16, 2, 32, 128, 0),
    (8, 4, 64, 64, 0),
    (16, 1, 64, 128, 192),  # start = 192*128 (aligned)
    (16, 2, 32, 128, 1001),  # start = 1001*128 (misaligned)
    (4, 1, 16, 128, 77),  # start = 77*128
]


@pytest.mark.parametrize("shape", PIPELINE_SHAPES)
def test_generator_is_bits_inverse_cdf_then_bridge(
    shape: tuple[int, int, int, int, int]
) -> None:
    """qmc_effective_normals_multi is exactly the composition of its pieces:
    the shifted split-table Sobol bits at the global point offset, the
    erf_inv inverse CDF, then ONE HIGHEST-precision bridge contraction over
    the level axis (factor-major de-interleave) — at aligned and misaligned
    row offsets."""
    from spectralmc_tpu.ops.qmc import _inv_cdf, _qmc_tables, qmc_effective_normals_multi
    from spectralmc_tpu.ops.sobol import sobol_uint32_t

    T, F, rows, cols, off = shape
    key = jax.random.PRNGKey(7)
    sdims = qmc_sobol_dims(T, F)
    assert sdims == T * F, "test shapes must be unpadded"
    dnp, snp = _qmc_tables(sdims, 31)
    shift_key, _ = jax.random.split(key)
    draw_shift = jax.random.bits(shift_key, (sdims,), dtype=jnp.uint32)
    start = jnp.uint32(off) * jnp.uint32(cols)
    bits = sobol_uint32_t(jnp.asarray(dnp), jnp.asarray(snp) ^ draw_shift, start, rows * cols)
    z = _inv_cdf(bits).reshape(T, F, rows * cols)
    bb = jnp.asarray(brownian_bridge_matrix(T), dtype=jnp.float32)
    want = jax.lax.dot_general(
        bb, z, (((1,), (0,)), ((), ())), precision=jax.lax.Precision.HIGHEST
    ).reshape(T, F, rows, cols)
    got = qmc_effective_normals_multi(
        key, timesteps=T, factors=F, rows=rows, cols=cols, dtype=jnp.float32,
        mc_seed=31, row_offset=off,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_public_generator_shape() -> None:
    """The public multi-factor generator runs end to end on the XLA path."""
    from spectralmc_tpu.ops.qmc import qmc_effective_normals_multi

    out = qmc_effective_normals_multi(
        jax.random.PRNGKey(3), timesteps=16, factors=1, rows=8, cols=128,
        dtype=jnp.float32, mc_seed=5,
    )
    assert out.shape == (16, 1, 8, 128)
    assert bool(jnp.isfinite(out).all())


def test_asian_geometric_qmc_walk_runs() -> None:
    """The Asian-geometric SOBOL_BB sim takes the scan over the bridged
    normals and prices finitely."""
    contract = jnp.asarray([100.0, 100.0, 1.0, 0.03, 0.01, 0.2], jnp.float32)
    out = simulate_underlier_rows(
        jax.random.PRNGKey(3), contract, timesteps=16, rows=8, cols=128,
        dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
        payoff=PayoffKind.ASIAN_GEOMETRIC, sampling=SamplingKind.SOBOL_BB,
        mc_seed=5,
    )
    assert out.shape == (8, 128) and bool(jnp.isfinite(out).all())
