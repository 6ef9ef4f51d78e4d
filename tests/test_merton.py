"""Merton jump-diffusion model-family tests — extension beyond the reference
(GBM-only; async_normals.py:213-217 has no jump channel).

Oracle chain: Merton's exact series price (``merton_call_price``) is pinned
to the Black-Scholes limit at lam = 0 (an algebraic identity, not a
tolerance game), then the MC simulator is gated against the oracle with a
z-score, then the trainer runs end to end on the 9-dimensional Merton Sobol
domain with snapshot/resume bit-exactness.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectralmc_tpu.core.result import Failure
from spectralmc_tpu.ops.analytic import black_scholes_price
from spectralmc_tpu.ops.gbm import (
    ModelKind,
    PayoffKind,
    SamplingKind,
    SimImplementation,
    build_simulation_params,
    resolve_implementation,
)
from spectralmc_tpu.ops.merton import (
    MERTON_CONTRACT_DIM,
    MertonContract,
    merton_call_price,
    merton_expected_underlier_mean,
    simulate_merton_underlier_rows,
    validate_merton_contract,
)
from spectralmc_tpu.ops.sobol import BoundSpec
from tests.helpers import expect_failure, expect_success

PARAMS = dict(
    spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
    vol=0.2, lam=0.5, jump_mean=-0.1, jump_std=0.25,
)

MERTON_BOUNDS = {
    "spot": BoundSpec(lower=90.0, upper=110.0),
    "strike": BoundSpec(lower=90.0, upper=110.0),
    "maturity": BoundSpec(lower=0.5, upper=1.5),
    "rate": BoundSpec(lower=0.0, upper=0.05),
    "div_yield": BoundSpec(lower=0.0, upper=0.02),
    "vol": BoundSpec(lower=0.15, upper=0.3),
    "lam": BoundSpec(lower=0.05, upper=1.0),
    "jump_mean": BoundSpec(lower=-0.2, upper=0.05),
    "jump_std": BoundSpec(lower=0.1, upper=0.3),
}


def test_contract_validation() -> None:
    good = MertonContract(**PARAMS)
    assert expect_success(validate_merton_contract(good)) is good
    expect_failure(validate_merton_contract(MertonContract(**{**PARAMS, "jump_std": 0.0})))
    expect_failure(validate_merton_contract(MertonContract(**{**PARAMS, "lam": -0.1})))
    # lam = 0 is legal (pure GBM as a boundary case)
    expect_success(validate_merton_contract(MertonContract(**{**PARAMS, "lam": 0.0})))
    assert MERTON_CONTRACT_DIM == 9


def test_oracle_reduces_to_black_scholes_at_lam_zero() -> None:
    call_m, put_m = merton_call_price(**{**PARAMS, "lam": 0.0})
    bs = black_scholes_price(
        jnp.float64(PARAMS["spot"]), jnp.float64(PARAMS["strike"]),
        jnp.float64(PARAMS["maturity"]), jnp.float64(PARAMS["rate"]),
        jnp.float64(PARAMS["div_yield"]), jnp.float64(PARAMS["vol"]),
    )
    assert abs(call_m - float(bs.call)) < 1e-10
    assert abs(put_m - float(bs.put)) < 1e-10


def test_oracle_parity_and_jump_risk_monotonicity() -> None:
    call, put = merton_call_price(**PARAMS)
    df_r = np.exp(-PARAMS["rate"] * PARAMS["maturity"])
    df_q = np.exp(-PARAMS["div_yield"] * PARAMS["maturity"])
    # put-call parity (the compensator keeps the discounted spot a martingale)
    assert abs((call - put) - (df_q * PARAMS["spot"] - df_r * PARAMS["strike"])) < 1e-10
    # more jump risk = more total variance = dearer ATM options
    call_hi, _ = merton_call_price(**{**PARAMS, "lam": 2.0})
    assert call_hi > call > float(
        black_scholes_price(
            jnp.float64(100.0), jnp.float64(100.0), jnp.float64(1.0),
            jnp.float64(0.03), jnp.float64(0.01), jnp.float64(0.2),
        ).call
    )


def test_mc_matches_series_price() -> None:
    call_exact, _ = merton_call_price(**PARAMS)
    contract = MertonContract(**PARAMS)
    out = np.asarray(
        simulate_merton_underlier_rows(
            jax.random.PRNGKey(3), contract.as_array(jnp.float64),
            timesteps=16, rows=128, cols=1024, dtype=jnp.float64,
            payoff=PayoffKind.TERMINAL,
        )
    ).reshape(-1)
    df = np.exp(-PARAMS["rate"] * PARAMS["maturity"])
    calls = df * np.maximum(out - PARAMS["strike"], 0.0)
    se = calls.std() / np.sqrt(calls.size)
    z = (calls.mean() - call_exact) / se
    assert abs(z) < 4.0, f"MC {calls.mean():.4f} vs exact {call_exact:.4f}, z={z:.2f}"
    # martingale property of the compensated dynamics (exact transitions:
    # no discretization bias at all for the terminal law)
    z_fwd = (out.mean() - float(merton_expected_underlier_mean(
        contract.as_array(jnp.float64), timesteps=16,
        payoff=PayoffKind.TERMINAL, dtype=jnp.float64,
    ))) / (out.std() / np.sqrt(out.size))
    assert abs(z_fwd) < 4.0


def test_shard_stable_row_offset() -> None:
    contract = MertonContract(**PARAMS).as_array(jnp.float32)
    key = jax.random.PRNGKey(9)
    kw = dict(timesteps=4, cols=128, dtype=jnp.float32, payoff=PayoffKind.TERMINAL)
    full = np.asarray(simulate_merton_underlier_rows(key, contract, rows=16, **kw))
    hi = np.asarray(simulate_merton_underlier_rows(key, contract, rows=8, row_offset=8, **kw))
    assert np.array_equal(hi, full[8:])


def test_antithetic_pairs_share_jump_counts() -> None:
    """The antithetic half reuses the first half's row keys (gbm._row_streams),
    so Poisson counts are common random numbers while both normals flip. The
    sharp check: with vol = 0 and jump_std -> tiny, log S_T is count-driven,
    so mirrored rows must agree (same counts); with vol > 0 they must not."""
    contract = MertonContract(
        **{**PARAMS, "vol": 1e-8, "jump_std": 1e-8, "lam": 5.0}
    ).as_array(jnp.float64)
    key = jax.random.PRNGKey(4)
    kw = dict(timesteps=4, cols=64, dtype=jnp.float64, payoff=PayoffKind.TERMINAL)
    anti = np.asarray(
        simulate_merton_underlier_rows(key, contract, rows=8, antithetic_half=4, **kw)
    )
    # counts identical, gaussians negligible -> mirrored rows nearly equal
    assert np.allclose(anti[:4], anti[4:], rtol=1e-5)
    # and the first half IS the plain rows=4 stream (pairing convention)
    plain = np.asarray(simulate_merton_underlier_rows(key, contract, rows=4, **kw))
    assert np.array_equal(anti[:4], plain)


def test_qmc_hybrid_reduces_vanilla_rmse() -> None:
    """SOBOL_BB on Merton stratifies the diffusion skeleton only (the jump
    channel stays pseudo). At lam = 0.1 the diffusion carries nearly all the
    variance, so the hybrid must still beat pseudo clearly at equal budget."""
    p = {**PARAMS, "lam": 0.1}
    truth, _ = merton_call_price(**p)
    contract = MertonContract(**p).as_array(jnp.float32)
    df = np.exp(-p["rate"] * p["maturity"])

    def replicates(sampling: SamplingKind) -> np.ndarray:
        out = []
        for i in range(8):
            rows = simulate_merton_underlier_rows(
                jax.random.fold_in(jax.random.PRNGKey(77), i), contract,
                timesteps=16, rows=16, cols=256, dtype=jnp.float32,
                payoff=PayoffKind.TERMINAL, sampling=sampling, mc_seed=31,
            )
            out.append(df * float(jnp.mean(jnp.maximum(rows - contract[1], 0.0))))
        return np.array(out)

    rmse_q = float(np.sqrt(np.mean((replicates(SamplingKind.SOBOL_BB) - truth) ** 2)))
    rmse_p = float(np.sqrt(np.mean((replicates(SamplingKind.PSEUDO) - truth) ** 2)))
    assert rmse_q < rmse_p / 2.0, f"hybrid qmc rmse {rmse_q} vs pseudo {rmse_p}"


def test_config_gates() -> None:
    base = dict(mc_seed=1, timesteps=4, network_size=16, batches_per_mc_run=4,
                model=ModelKind.MERTON_JUMP)
    # geometric-Asian mean has no closed form -> MEAN normalization rejected
    assert isinstance(
        build_simulation_params(**base, payoff=PayoffKind.ASIAN_GEOMETRIC), Failure
    )
    expect_success(
        build_simulation_params(
            **base, payoff=PayoffKind.ASIAN_GEOMETRIC, normalization="none"
        )
    )
    # only the exact log-space transition is defined
    assert isinstance(build_simulation_params(**base, scheme="euler"), Failure)
    # American kinds are supported under jumps (ops/american.py)
    expect_success(
        build_simulation_params(
            **base, payoff=PayoffKind.AMERICAN_PUT, normalization="none"
        )
    )
    # PALLAS at a non-tileable shape (cols % 128 != 0) resolves to XLA ...
    sim = expect_success(build_simulation_params(**base, implementation="pallas"))
    assert resolve_implementation(sim) == SimImplementation.XLA
    # ... and at kernel shapes the fused merton kernel honors PALLAS on the GPU
    sim_ok = expect_success(
        build_simulation_params(
            **{**base, "network_size": 128, "batches_per_mc_run": 8},
            implementation="pallas",
        )
    )
    expected = (
        SimImplementation.PALLAS
        if jax.default_backend() == "gpu"
        else SimImplementation.XLA
    )
    assert resolve_implementation(sim_ok) == expected


def test_asian_and_barrier_smoke() -> None:
    contract = MertonContract(**PARAMS).as_array(jnp.float32)
    key = jax.random.PRNGKey(2)
    kw = dict(timesteps=8, rows=8, cols=128, dtype=jnp.float32)
    asian = np.asarray(
        simulate_merton_underlier_rows(key, contract, payoff=PayoffKind.ASIAN_ARITHMETIC, **kw)
    )
    assert np.all(np.isfinite(asian)) and np.all(asian > 0)
    # arithmetic average sits below the terminal forward (positive drift path
    # averages early values) — sanity, not a sharp gate
    up_out = np.asarray(
        simulate_merton_underlier_rows(
            key, contract, payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=1.3, **kw
        )
    )
    assert np.all(np.isfinite(up_out))
    # knocked paths emit exactly the strike (masked-underlier convention);
    # a 30% barrier under jumpy dynamics knocks some but not all paths
    knocked_share = float(np.mean(up_out == np.float32(PARAMS["strike"])))
    assert 0.0 < knocked_share < 1.0


def test_greeks_on_merton() -> None:
    from spectralmc_tpu.ops.greeks import OptionSide, bump_greeks, mc_greeks

    sim = expect_success(
        build_simulation_params(
            mc_seed=11, timesteps=8, network_size=256, batches_per_mc_run=64,
            model=ModelKind.MERTON_JUMP, precision="float64",
        )
    )
    contract = MertonContract(**PARAMS)
    ipa = mc_greeks(sim, contract, option=OptionSide.CALL)
    fd = bump_greeks(sim, contract, option=OptionSide.CALL)
    assert ipa.engine == SimImplementation.XLA
    assert 0.0 < ipa.delta < 1.0
    assert ipa.by_field["vol"] > 0.0  # vega
    assert ipa.by_field["jump_std"] > 0.0  # ATM: more jump variance = dearer
    # pathwise and FD agree on the smooth fields
    assert abs(ipa.delta - fd.delta) < 0.02
    assert abs(ipa.by_field["vol"] - fd.by_field["vol"]) < 0.5
    # lam: the envelope (fixed-count) IPA misses the count channel; the bump
    # estimator carries it — both finite, and the bump lam-Greek is positive
    # (ATM price increases with jump intensity)
    assert np.isfinite(ipa.by_field["lam"]) and np.isfinite(fd.by_field["lam"])
    assert fd.by_field["lam"] > 0.0


def test_trainer_end_to_end_on_merton_domain() -> None:
    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
    from spectralmc_tpu.training.trainer import (
        GbmCVNNPricer,
        GbmCVNNPricerConfig,
        build_training_config,
    )

    sim = expect_success(
        build_simulation_params(
            mc_seed=5, timesteps=4, network_size=32, batches_per_mc_run=8,
            model=ModelKind.MERTON_JUMP,
        )
    )
    cvnn = expect_success(
        build_cvnn_config(layers=[LinearCfg(width=24, activation=Activation.MODRELU)], seed=7)
    )
    cfg = GbmCVNNPricerConfig(sim=sim, bounds=MERTON_BOUNDS, cvnn=cvnn)
    pricer = expect_success(GbmCVNNPricer.create(cfg))
    tc = expect_success(build_training_config(num_batches=25, batch_size=8, learning_rate=2e-3))
    result = expect_success(pricer.train(tc))
    assert np.all(np.isfinite(result.losses))
    assert result.losses[-5:].mean() < result.losses[:5].mean()

    # snapshot/resume bit-exactness holds for the new family too
    snap = pricer.snapshot()
    a = expect_success(GbmCVNNPricer.create(snap))
    b = expect_success(GbmCVNNPricer.create(snap))
    tc2 = expect_success(build_training_config(num_batches=3, batch_size=4, learning_rate=1e-3))
    ra = expect_success(a.train(tc2))
    rb = expect_success(b.train(tc2))
    assert np.array_equal(ra.losses, rb.losses)

    # inference path: 9-field contracts in, finite prices out
    pred = a.predict_price([MertonContract(**PARAMS)])
    assert np.all(np.isfinite(pred.put)) and np.all(np.isfinite(pred.call))


def test_proto_roundtrip_with_model_kind() -> None:
    from spectralmc_tpu.serialization.converters import (
        sim_params_from_proto,
        sim_params_to_proto,
    )

    sim = expect_success(
        build_simulation_params(
            mc_seed=2, timesteps=4, network_size=16, batches_per_mc_run=4,
            model=ModelKind.MERTON_JUMP, payoff=PayoffKind.ASIAN_ARITHMETIC,
        )
    )
    back = expect_success(sim_params_from_proto(sim_params_to_proto(sim)))
    assert back == sim and back.model == ModelKind.MERTON_JUMP


def test_sharded_merton_matches_single_device() -> None:
    import math

    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config, build_model
    from spectralmc_tpu.ops.sobol import SobolConfig, SobolSampler
    from spectralmc_tpu.parallel.mesh import build_mesh_spec
    from spectralmc_tpu.parallel.trainer import make_sharded_segment
    from spectralmc_tpu.training.step import SobolTable, make_fused_batch, make_optimizer

    sim = expect_success(
        build_simulation_params(
            mc_seed=3, timesteps=2, network_size=16, batches_per_mc_run=4,
            model=ModelKind.MERTON_JUMP,
        )
    )
    cvnn = expect_success(
        build_cvnn_config(layers=[LinearCfg(width=16, activation=Activation.ZRELU)], seed=1)
    )
    model = expect_success(build_model(cvnn, input_dim=9, output_dim=sim.network_size))
    sampler = expect_success(
        SobolSampler.create(MertonContract, MERTON_BOUNDS, SobolConfig(seed=3))
    )
    dt = sampler.device_table()
    table = SobolTable(directions=dt["directions"], shift=dt["shift"],
                       lower=dt["lower"], upper=dt["upper"])
    params, bn = model.init()
    carry = {
        "params": params, "bn_state": bn,
        "opt_state": make_optimizer(1e-3).init(params),
        "sobol_skip": jnp.uint32(0), "mc_skip": jnp.uint32(0),
    }
    one = make_fused_batch(model, sim, table, batch_size=8, learning_rate=1e-3)
    ref_carry, (ref_loss, _) = jax.jit(
        lambda c: jax.lax.scan(one, c, None, length=3)
    )(carry)

    spec = expect_success(build_mesh_spec(batch_shards=4, paths_shards=2))
    run = make_sharded_segment(model, sim, table, batch_size=8, learning_rate=1e-3,
                               spec=spec, length=3)
    _, (sh_loss, _) = run(carry)
    rel = np.abs(np.asarray(sh_loss) - np.asarray(ref_loss)) / np.abs(np.asarray(ref_loss))
    assert rel.max() < 1e-4, f"sharded vs single-device loss diff {rel.max():.2e}"
    assert all(math.isfinite(float(x)) for x in np.asarray(sh_loss))
