"""Trainer tests (parity: reference tests/test_gbm_trainer.py docstring items).

Gates: deterministic construction, lock-step training determinism between
cloned pricers, snapshot/restore == continuous training (bit-exact), restart
without optimizer state, commit-plan semantics, predict_price smoke.
"""

from __future__ import annotations

import numpy as np
import pytest

from spectralmc_tpu.core.errors.trainer import (
    CheckpointMismatch,
    CommitPlanMismatch,
    InvalidTrainingConfig,
)
from spectralmc_tpu.core.precision import Precision
from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
from spectralmc_tpu.training.trainer import (
    FinalAndIntervalCommit,
    FinalCommit,
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    IntervalCommit,
    NoCommit,
    build_training_config,
)
from tests.helpers import expect_failure, expect_success
from tests.helpers.factories import CONTRACT_BOUNDS, make_contract, make_simulation_params


def make_pricer_config(
    *, precision: Precision = Precision.float32, seed: int = 3, **sim_kwargs: object
) -> GbmCVNNPricerConfig:
    sim = make_simulation_params(
        timesteps=2, network_size=16, batches_per_mc_run=4, precision=precision, **sim_kwargs
    )
    cvnn = expect_success(
        build_cvnn_config(
            layers=[LinearCfg(width=24, activation=Activation.MODRELU)],
            seed=seed,
            precision=precision,
        )
    )
    return GbmCVNNPricerConfig(sim=sim, bounds=CONTRACT_BOUNDS, cvnn=cvnn)


def make_training(num_batches: int = 4, batch_size: int = 4, lr: float = 1e-3):
    return expect_success(
        build_training_config(num_batches=num_batches, batch_size=batch_size, learning_rate=lr)
    )


def test_training_config_validation() -> None:
    assert isinstance(
        expect_failure(build_training_config(num_batches=0, batch_size=1, learning_rate=0.1)),
        InvalidTrainingConfig,
    )
    assert isinstance(
        expect_failure(build_training_config(num_batches=1, batch_size=1, learning_rate=1.5)),
        InvalidTrainingConfig,
    )


def test_loss_decreases() -> None:
    pricer = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    result = expect_success(pricer.train(make_training(num_batches=40, batch_size=8, lr=3e-3)))
    head = float(np.mean(result.losses[:5]))
    tail = float(np.mean(result.losses[-5:]))
    assert tail < head, f"loss did not decrease: head={head} tail={tail}"
    assert np.isfinite(result.final_grad_norm)


def test_lockstep_determinism() -> None:
    """Two pricers from the same config train identically (bit-exact)."""
    a = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    b = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    ra = expect_success(a.train(make_training(num_batches=6)))
    rb = expect_success(b.train(make_training(num_batches=6)))
    np.testing.assert_array_equal(ra.losses, rb.losses)
    sa, sb = a.snapshot(), b.snapshot()
    assert set(sa.model_state) == set(sb.model_state)
    for key in sa.model_state:
        np.testing.assert_array_equal(sa.model_state[key], sb.model_state[key])


def test_snapshot_restore_equals_continuous() -> None:
    """Resume == continuous training, bit-exact (the flagship contract)."""
    continuous = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    r_full = expect_success(continuous.train(make_training(num_batches=8)))

    first = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    expect_success(first.train(make_training(num_batches=4)))
    snap = first.snapshot()
    assert snap.global_step == 4
    assert snap.sobol_skip == 16  # 4 batches x 4 contracts
    restored = expect_success(GbmCVNNPricer.create(snap))
    r_resumed = expect_success(restored.train(make_training(num_batches=4)))

    np.testing.assert_array_equal(r_full.losses[4:], r_resumed.losses)
    s_cont, s_res = continuous.snapshot(), restored.snapshot()
    for key in s_cont.model_state:
        np.testing.assert_array_equal(s_cont.model_state[key], s_res.model_state[key])
    assert s_cont.optimizer_state.count == s_res.optimizer_state.count
    for key in s_cont.optimizer_state.mu:
        np.testing.assert_array_equal(
            s_cont.optimizer_state.mu[key], s_res.optimizer_state.mu[key]
        )
        np.testing.assert_array_equal(
            s_cont.optimizer_state.nu[key], s_res.optimizer_state.nu[key]
        )


def test_restart_without_optimizer_state() -> None:
    pricer = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    expect_success(pricer.train(make_training(num_batches=2)))
    snap = pricer.snapshot()
    stripped = GbmCVNNPricerConfig(
        sim=snap.sim,
        bounds=snap.bounds,
        cvnn=snap.cvnn,
        global_step=snap.global_step,
        sobol_skip=snap.sobol_skip,
        model_state=snap.model_state,
        optimizer_state=None,
    )
    restarted = expect_success(GbmCVNNPricer.create(stripped))
    result = expect_success(restarted.train(make_training(num_batches=2)))
    assert np.isfinite(result.final_loss)


def test_commit_plan_validation_and_execution() -> None:
    pricer = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    err = expect_failure(
        pricer.train(make_training(num_batches=2), commit_plan=FinalCommit())
    )
    assert isinstance(err, CommitPlanMismatch)
    err2 = expect_failure(
        pricer.train(make_training(num_batches=2), commit_fn=lambda s, m: None)
    )
    assert isinstance(err2, CommitPlanMismatch)

    commits: list[tuple[int, str]] = []

    def record(snapshot: GbmCVNNPricerConfig, message: str) -> None:
        commits.append((snapshot.global_step, message))

    expect_success(
        pricer.train(
            make_training(num_batches=5),
            commit_plan=FinalAndIntervalCommit(interval=2),
            commit_fn=record,
        )
    )
    # interval commits at batches 2, 4; final commit at 5
    assert [step for step, _ in commits] == [2, 4, 5]
    assert "loss=" in commits[0][1]

    commits.clear()
    pricer2 = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    expect_success(
        pricer2.train(
            make_training(num_batches=4),
            commit_plan=IntervalCommit(interval=2),
            commit_fn=record,
        )
    )
    assert [step for step, _ in commits] == [2, 4]


def test_global_step_and_skip_accumulate_across_calls() -> None:
    pricer = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    expect_success(pricer.train(make_training(num_batches=3, batch_size=2)))
    expect_success(pricer.train(make_training(num_batches=2, batch_size=2)))
    snap = pricer.snapshot()
    assert snap.global_step == 5
    assert snap.sobol_skip == 10
    assert snap.sim.skip == 10


def test_predict_price_smoke() -> None:
    pricer = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    expect_success(pricer.train(make_training(num_batches=4)))
    contracts = [make_contract(), make_contract(strike=120.0), make_contract(vol=0.4)]
    pred = pricer.predict_price(contracts)
    assert pred.put.shape == (3,)
    assert np.all(np.isfinite(pred.put))
    assert np.all(np.isfinite(pred.call))
    # put-call parity is enforced by construction
    c = contracts[1]
    fwd = c.spot * np.exp((c.rate - c.div_yield) * c.maturity)
    df = np.exp(-c.rate * c.maturity)
    np.testing.assert_allclose(pred.call[1] - pred.put[1], df * (fwd - c.strike), rtol=1e-5)


@pytest.mark.parametrize("precision", [Precision.float32, Precision.float64])
def test_both_precisions_train(precision: Precision) -> None:
    pricer = expect_success(GbmCVNNPricer.create(make_pricer_config(precision=precision)))
    result = expect_success(pricer.train(make_training(num_batches=2)))
    assert np.isfinite(result.final_loss)


def test_step_callback_receives_metrics() -> None:
    pricer = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    seen: list[int] = []
    pricer.set_step_callback(lambda m: seen.append(m.step))
    expect_success(pricer.train(make_training(num_batches=3)))
    assert seen == [1, 2, 3]


# ---------------------------------------------------------------------------
# effect-interpreted training (the path the reference left as a placeholder,
# gbm_trainer.py:1686-1703 — here it is the real driver)
# ---------------------------------------------------------------------------


def test_train_via_effects_equals_train_bit_exact() -> None:
    cfg = make_pricer_config()
    a = expect_success(GbmCVNNPricer.create(cfg))
    b = expect_success(GbmCVNNPricer.create(cfg))
    tc = make_training(num_batches=6)
    ra = expect_success(a.train(tc))
    rb = expect_success(b.train_via_effects(tc))
    assert np.array_equal(ra.losses, rb.losses)
    assert np.array_equal(ra.grad_norms, rb.grad_norms)
    sa, sb = ra.updated_config, rb.updated_config
    assert sa.global_step == sb.global_step
    assert sa.sobol_skip == sb.sobol_skip
    assert sa.sim.skip == sb.sim.skip
    for k in sa.model_state:
        assert np.array_equal(sa.model_state[k], sb.model_state[k]), k
    assert sa.optimizer_state.count == sb.optimizer_state.count
    for k in sa.optimizer_state.mu:
        assert np.array_equal(sa.optimizer_state.mu[k], sb.optimizer_state.mu[k]), k
        assert np.array_equal(sa.optimizer_state.nu[k], sb.optimizer_state.nu[k]), k


def test_train_via_effects_commit_boundaries_match_train() -> None:
    cfg = make_pricer_config()
    tc = make_training(num_batches=5)

    def run(method_name: str) -> list[tuple[int, str]]:
        pricer = expect_success(GbmCVNNPricer.create(cfg))
        commits: list[tuple[int, str]] = []
        method = getattr(pricer, method_name)
        expect_success(
            method(
                tc,
                commit_plan=FinalAndIntervalCommit(interval=2),
                commit_fn=lambda snap, msg: commits.append((snap.global_step, msg)),
            )
        )
        return commits

    assert run("train") == run("train_via_effects")


def test_train_via_effects_plan_validation() -> None:
    pricer = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    failure = pricer.train_via_effects(make_training(), commit_plan=FinalCommit())
    assert isinstance(expect_failure(failure), CommitPlanMismatch)


def test_train_via_effects_inside_running_event_loop() -> None:
    """The effect driver must work when called from async context (the
    storage layer is async-first)."""
    import asyncio

    pricer = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    tc = make_training(num_batches=2)

    async def orchestrate():
        return pricer.train_via_effects(tc)

    result = expect_success(asyncio.run(orchestrate()))
    assert result.total_batches == 2


def test_predict_parity_uses_payoff_mean_for_asians() -> None:
    """call - put must equal df*(E[average] - K), not df*(forward - K)."""
    from spectralmc_tpu.ops.gbm import PayoffKind, expected_underlier_mean
    import jax.numpy as jnp

    cfg = make_pricer_config(payoff=PayoffKind.ASIAN_ARITHMETIC)
    pricer = expect_success(GbmCVNNPricer.create(cfg))
    expect_success(pricer.train(make_training(num_batches=2)))
    contract = make_contract(rate=0.05, div_yield=0.0, maturity=1.0)
    pred = pricer.predict_price([contract])
    arr = contract.as_array(jnp.float64)
    expected_avg = float(expected_underlier_mean(
        arr, timesteps=cfg.sim.timesteps, payoff=PayoffKind.ASIAN_ARITHMETIC,
        dtype=jnp.float64,
    ))
    df = np.exp(-contract.rate * contract.maturity)
    parity = float(pred.call[0] - pred.put[0])
    assert abs(parity - df * (expected_avg - contract.strike)) < 1e-3
    # and it must NOT be terminal-forward parity (differs by ~2.4 here)
    fwd = contract.spot * np.exp((contract.rate - contract.div_yield) * contract.maturity)
    assert abs(parity - df * (fwd - contract.strike)) > 1.0


@pytest.mark.slow
def test_convergence_quality_gate() -> None:
    """The whole-method gate: after 600 online batches on a narrow domain the
    CVNN's IFFT-recovered put price lands within 5% of analytic Black-Scholes
    (the verify drive's criterion, made durable in CI)."""
    from spectralmc_tpu.ops.analytic import black_scholes_price
    from spectralmc_tpu.ops.sobol import BoundSpec

    bounds = {
        "spot": BoundSpec(lower=95.0, upper=105.0),
        "strike": BoundSpec(lower=95.0, upper=105.0),
        "maturity": BoundSpec(lower=0.5, upper=1.5),
        "rate": BoundSpec(lower=0.01, upper=0.05),
        "div_yield": BoundSpec(lower=0.0, upper=0.02),
        "vol": BoundSpec(lower=0.2, upper=0.3),
    }
    sim = make_simulation_params(timesteps=8, network_size=32, batches_per_mc_run=64)
    cvnn = expect_success(
        build_cvnn_config(
            layers=[
                LinearCfg(width=64, activation=Activation.MODRELU),
                LinearCfg(width=64, activation=Activation.ZRELU),
            ],
            seed=5,
        )
    )
    pricer = expect_success(
        GbmCVNNPricer.create(GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=cvnn))
    )
    tc = expect_success(
        build_training_config(num_batches=600, batch_size=32, learning_rate=2e-3)
    )
    result = expect_success(pricer.train(tc))
    assert result.final_loss < 0.1 * result.losses[0]

    contract = make_contract(spot=100.0, strike=100.0, maturity=1.0, rate=0.03,
                             div_yield=0.01, vol=0.25)
    pred = pricer.predict_price([contract])
    import jax.numpy as jnp

    ana = black_scholes_price(
        jnp.float64(100.0), jnp.float64(100.0), jnp.float64(1.0),
        jnp.float64(0.03), jnp.float64(0.01), jnp.float64(0.25),
    )
    rel = abs(float(pred.put[0]) - float(ana.put)) / float(ana.put)
    assert rel < 0.05, f"learned put off by {rel:.1%}"


# --------------------------------------------------------------------------
# Engine recording / mismatch (determinism contract across backends)
# --------------------------------------------------------------------------


def test_fresh_pallas_request_downgrades_and_records_effective_engine() -> None:
    """On a backend where the Pallas kernel can't run, a FRESH config is
    downgraded with a warning and the snapshot records the engine that
    actually ran (never a silent lie in the checkpoint)."""
    from spectralmc_tpu.ops.gbm import SimImplementation

    config = make_pricer_config(implementation=SimImplementation.PALLAS)
    pricer = expect_success(GbmCVNNPricer.create(config))
    expect_success(pricer.train(make_training(num_batches=2)))
    snap = pricer.snapshot()
    assert snap.sim.implementation == SimImplementation.XLA


def test_midstream_pallas_checkpoint_fails_loud_off_tpu() -> None:
    """Resuming a mid-stream PALLAS checkpoint where the kernel can't run is
    an EngineMismatch failure — the bit stream would silently change."""
    from spectralmc_tpu.core.errors.trainer import EngineMismatch
    from spectralmc_tpu.ops.gbm import SimImplementation

    base = make_pricer_config(implementation=SimImplementation.PALLAS)
    midstream = GbmCVNNPricerConfig(
        sim=base.sim, bounds=base.bounds, cvnn=base.cvnn, global_step=4, sobol_skip=16
    )
    err = expect_failure(GbmCVNNPricer.create(midstream))
    assert isinstance(err, EngineMismatch)
    assert err.requested == "pallas" and err.effective == "xla"

    # explicit opt-in accepts the stream break and trains on
    pricer = expect_success(GbmCVNNPricer.create(midstream, allow_engine_fallback=True))
    expect_success(pricer.train(make_training(num_batches=1)))
    assert pricer.snapshot().sim.implementation == SimImplementation.XLA


def test_resolve_implementation_is_the_fallback_predicate() -> None:
    from spectralmc_tpu.ops.gbm import SimImplementation, resolve_implementation

    xla_sim = make_simulation_params()
    assert resolve_implementation(xla_sim) == SimImplementation.XLA
    pallas_sim = make_simulation_params(implementation=SimImplementation.PALLAS)
    # CPU backend: the hardware kernel can never run
    assert resolve_implementation(pallas_sim) == SimImplementation.XLA


# --------------------------------------------------------------------------
# Segment (bulk) metrics callback
# --------------------------------------------------------------------------


def test_segment_callback_matches_per_step_metrics() -> None:
    from spectralmc_tpu.training.trainer import IntervalCommit

    per_step: list = []
    segments: list = []
    pricer = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    pricer.set_step_callback(per_step.append)
    pricer.set_segment_callback(segments.append)
    commits: list = []
    expect_success(
        pricer.train(
            make_training(num_batches=5, batch_size=4),
            commit_plan=IntervalCommit(interval=2),
            commit_fn=lambda snap, msg: commits.append(msg),
        )
    )
    # 5 batches at interval 2 -> segments of [2, 2, 1]
    assert [len(s.losses) for s in segments] == [2, 2, 1]
    assert segments[0].start_step == 1
    assert segments[1].start_step == 3
    assert segments[2].start_step == 5
    flat_losses = np.concatenate([s.losses for s in segments])
    assert len(per_step) == 5
    np.testing.assert_array_equal(flat_losses, [m.loss for m in per_step])
    assert [m.step for m in per_step] == [1, 2, 3, 4, 5]


def test_profile_dir_writes_trace(tmp_path) -> None:
    """profile_dir turns on jax.profiler capture around the train call."""
    pricer = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    profile_dir = str(tmp_path / "trace")
    expect_success(
        pricer.train(make_training(num_batches=2), profile_dir=profile_dir)
    )
    import pathlib

    produced = list(pathlib.Path(profile_dir).rglob("*"))
    assert any(p.is_file() for p in produced), "profiler wrote no trace files"


def test_contract_chunking_is_bit_transparent() -> None:
    """lax.map chunked spectrum targets == one-vmap targets, to the bit —
    chunking is pure scheduling (production batches exceed HBM vmapped)."""
    full = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    chunked = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    rf = expect_success(full.train(make_training(num_batches=3, batch_size=8)))
    rc = expect_success(
        chunked.train(
            expect_success(
                build_training_config(
                    num_batches=3, batch_size=8, learning_rate=1e-3, contract_chunk=2
                )
            )
        )
    )
    np.testing.assert_array_equal(rf.losses, rc.losses)
    sf, sc = full.snapshot(), chunked.snapshot()
    for key in sf.model_state:
        np.testing.assert_array_equal(sf.model_state[key], sc.model_state[key])


def test_contract_chunk_validation() -> None:
    assert isinstance(
        expect_failure(
            build_training_config(
                num_batches=1, batch_size=8, learning_rate=0.1, contract_chunk=3
            )
        ),
        InvalidTrainingConfig,
    )
    assert isinstance(
        expect_failure(
            build_training_config(
                num_batches=1, batch_size=8, learning_rate=0.1, contract_chunk=0
            )
        ),
        InvalidTrainingConfig,
    )


def test_normalize_inputs_resume_and_wire_roundtrip() -> None:
    """normalize_inputs is part of the model's function: it survives
    snapshot/resume (bit-exact) and the proto wire format."""
    from spectralmc_tpu.serialization import deserialize_checkpoint, serialize_checkpoint

    base = make_pricer_config()
    norm_cfg = GbmCVNNPricerConfig(
        sim=base.sim, bounds=base.bounds, cvnn=base.cvnn, normalize_inputs=True
    )
    continuous = expect_success(GbmCVNNPricer.create(norm_cfg))
    r_full = expect_success(continuous.train(make_training(num_batches=6)))

    half = expect_success(GbmCVNNPricer.create(norm_cfg))
    expect_success(half.train(make_training(num_batches=3)))
    data, digest = serialize_checkpoint(half.snapshot())
    restored_cfg = expect_success(deserialize_checkpoint(data, expected_hash=digest))
    assert restored_cfg.normalize_inputs is True
    restored = expect_success(GbmCVNNPricer.create(restored_cfg))
    r_resumed = expect_success(restored.train(make_training(num_batches=3)))
    np.testing.assert_array_equal(r_full.losses[3:], r_resumed.losses)

    # normalization actually changes the program (different trajectories)
    plain = expect_success(GbmCVNNPricer.create(base))
    r_plain = expect_success(plain.train(make_training(num_batches=6)))
    assert not np.array_equal(r_plain.losses, r_full.losses)

    # predict runs the same normalized program without error
    pred = continuous.predict_price([make_contract()])
    assert np.isfinite(pred.put).all()


def test_normalize_inputs_sharded_matches_single_device() -> None:
    from spectralmc_tpu.parallel.mesh import build_mesh_spec

    base = make_pricer_config()
    cfg = GbmCVNNPricerConfig(
        sim=base.sim, bounds=base.bounds, cvnn=base.cvnn, normalize_inputs=True
    )
    spec = expect_success(build_mesh_spec(batch_shards=2, paths_shards=2))
    single = expect_success(GbmCVNNPricer.create(cfg))
    sharded = expect_success(GbmCVNNPricer.create(cfg, mesh_spec=spec))
    rs = expect_success(single.train(make_training(num_batches=3, batch_size=4)))
    rm = expect_success(sharded.train(make_training(num_batches=3, batch_size=4)))
    np.testing.assert_allclose(rs.losses, rm.losses, rtol=2e-4)


def test_mesh_incompatible_contract_chunk_is_a_failure_not_a_crash() -> None:
    """A chunk valid for the global batch but not the per-shard slice must
    surface as Failure(InvalidTrainingConfig), never a raw ValueError."""
    from spectralmc_tpu.parallel.mesh import build_mesh_spec

    spec = expect_success(build_mesh_spec(batch_shards=4, paths_shards=2))
    pricer = expect_success(GbmCVNNPricer.create(make_pricer_config(), mesh_spec=spec))
    # 8 divides batch 16, but per-shard batch is 16/4 = 4 and 4 % 8 != 0...
    # chunk >= local_b degrades to vmap (fine); use chunk=3: divides nothing
    tc = expect_success(
        build_training_config(
            num_batches=1, batch_size=24, learning_rate=1e-3, contract_chunk=3
        )
    )
    # per-shard batch 24/4 = 6; 6 % 3 == 0 -> fine
    expect_success(pricer.train(tc))
    tc_bad = expect_success(
        build_training_config(
            num_batches=1, batch_size=16, learning_rate=1e-3, contract_chunk=16
        )
    )
    # per-shard batch 4, chunk 16 >= 4 -> degrades to vmap, still fine
    expect_success(pricer.train(tc_bad))
    # manufactured mismatch: batch 40, chunk 8 divides 40 but not 40/4=10
    tc_mismatch = expect_success(
        build_training_config(
            num_batches=1, batch_size=40, learning_rate=1e-3, contract_chunk=8
        )
    )
    err = expect_failure(pricer.train(tc_mismatch))
    assert isinstance(err, InvalidTrainingConfig) and "per-shard" in err.reason


def test_pallas_stream_version_guard() -> None:
    """A mid-stream PALLAS checkpoint from a different kernel build fails
    loudly; same-build checkpoints resume; fresh configs get stamped."""
    from spectralmc_tpu.core.errors.trainer import EngineMismatch
    from spectralmc_tpu.ops.gbm import SimImplementation

    base = make_pricer_config()
    # on CPU pallas resolves to XLA, so snapshots record stream version 0
    pricer = expect_success(GbmCVNNPricer.create(base))
    assert pricer.snapshot().pallas_stream_version == 0

    # emulating the GPU side by monkey-patching resolution is heavy; instead
    # exercise the guard arithmetic directly against the real table
    from spectralmc_tpu.ops.gbm import ModelKind
    from spectralmc_tpu.ops.gbm_pallas import (
        PALLAS_STREAM_VERSIONS,
        pallas_stream_version,
    )

    assert pallas_stream_version(ModelKind.GBM) == PALLAS_STREAM_VERSIONS["gbm"]
    assert pallas_stream_version(ModelKind.HESTON) >= 2  # round-2 kernel


def test_pallas_stream_version_mismatch_fails_on_pallas_backend(
    monkeypatch: pytest.MonkeyPatch,
) -> None:
    from spectralmc_tpu.core.errors.trainer import EngineMismatch
    from spectralmc_tpu.ops.gbm import SimImplementation
    import spectralmc_tpu.training.trainer as trainer_mod

    # force "pallas actually runs here" so the stream check engages
    monkeypatch.setattr(
        trainer_mod, "resolve_implementation", lambda sim, rows=None: sim.implementation
    )
    base = make_pricer_config(implementation=SimImplementation.PALLAS)
    old_build = GbmCVNNPricerConfig(
        sim=base.sim, bounds=base.bounds, cvnn=base.cvnn,
        global_step=4, pallas_stream_version=1,
    )
    from spectralmc_tpu.ops.gbm_pallas import pallas_stream_version
    from spectralmc_tpu.ops.gbm import ModelKind

    current = pallas_stream_version(ModelKind.GBM)
    if current == 1:
        # GBM stream unchanged since v1: v1 checkpoints must still load
        pricer = expect_success(GbmCVNNPricer.create(old_build))
        assert pricer.snapshot().pallas_stream_version == 1
    # a checkpoint from a FUTURE/different build must fail loudly
    alien = GbmCVNNPricerConfig(
        sim=base.sim, bounds=base.bounds, cvnn=base.cvnn,
        global_step=4, pallas_stream_version=99,
    )
    err = expect_failure(GbmCVNNPricer.create(alien))
    assert isinstance(err, EngineMismatch) and "stream" in err.requested
    # explicit opt-in accepts the break and restamps the current version
    pricer = expect_success(GbmCVNNPricer.create(alien, allow_engine_fallback=True))
    assert pricer.snapshot().pallas_stream_version == current


def test_unrecognized_legacy_optimizer_state_is_a_failure() -> None:
    base = make_pricer_config()
    bad = GbmCVNNPricerConfig(
        sim=base.sim, bounds=base.bounds, cvnn=base.cvnn,
        optimizer_state={"bogus": np.zeros(1)},
    )
    err = expect_failure(GbmCVNNPricer.create(bad))
    assert isinstance(err, CheckpointMismatch) and err.field == "optimizer_state"


def test_predict_price_bucket_padding_is_bit_transparent() -> None:
    """pad_to_bucket pads the batch to the next power of two and slices
    back — results must equal the unpadded call bit-for-bit for every
    awkward batch size (the CVNN forward is row-independent)."""
    pricer = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    contracts = [
        make_contract(strike=90.0 + 3.0 * i, vol=0.15 + 0.02 * i) for i in range(7)
    ]
    for n in (1, 2, 3, 5, 7):
        plain = pricer.predict_price(contracts[:n])
        padded = pricer.predict_price(contracts[:n], pad_to_bucket=True)
        np.testing.assert_array_equal(padded.put, plain.put)
        np.testing.assert_array_equal(padded.call, plain.call)
        assert padded.put.shape == (n,)


def test_predict_greeks_bucket_padding_is_bit_transparent() -> None:
    pricer = expect_success(GbmCVNNPricer.create(make_pricer_config()))
    contracts = [make_contract(strike=92.0 + 4.0 * i) for i in range(3)]
    plain = pricer.predict_greeks(contracts)
    padded = pricer.predict_greeks(contracts, pad_to_bucket=True)
    np.testing.assert_array_equal(padded.put, plain.put)
    np.testing.assert_array_equal(padded.put_jacobian, plain.put_jacobian)
    np.testing.assert_array_equal(padded.put_gamma, plain.put_gamma)
    np.testing.assert_array_equal(padded.call_jacobian, plain.call_jacobian)
    assert padded.put.shape == (3,)


def test_removed_fused_lsmc_backward_is_a_typed_refusal() -> None:
    """build_simulation_params refuses lsmc_fused_backward=True and names the
    removal; False (the default) still builds."""
    from spectralmc_tpu.core.errors.gbm import InvalidSimulationParams
    from spectralmc_tpu.ops.gbm import build_simulation_params

    base = dict(
        timesteps=4, network_size=128, batches_per_mc_run=8, mc_seed=1,
        payoff="american_put", normalization="none",
    )
    err = expect_failure(build_simulation_params(**base, lsmc_fused_backward=True))
    assert isinstance(err, InvalidSimulationParams)
    assert err.field == "lsmc_fused_backward" and "removed" in err.reason
    assert not expect_success(
        build_simulation_params(**base, lsmc_fused_backward=False)
    ).lsmc_fused_backward


@pytest.mark.parametrize("recorded", [1, 2])
def test_removed_lsmc_backward_checkpoint_fails_mid_stream(recorded: int) -> None:
    """A mid-stream checkpoint that recorded a removed fused LSMC backward
    (versions 1 and 2) fails with EngineMismatch; opting in restamps the
    shared XLA backward (0); a fresh config is stamped 0 silently."""
    from spectralmc_tpu.core.errors.trainer import EngineMismatch

    base = make_pricer_config()
    old = GbmCVNNPricerConfig(
        sim=base.sim, bounds=base.bounds, cvnn=base.cvnn,
        global_step=4, lsmc_backward_version=recorded,
    )
    err = expect_failure(GbmCVNNPricer.create(old))
    assert isinstance(err, EngineMismatch) and "lsmc backward" in err.requested
    pricer = expect_success(GbmCVNNPricer.create(old, allow_engine_fallback=True))
    assert pricer.snapshot().lsmc_backward_version == 0
    fresh = GbmCVNNPricerConfig(
        sim=base.sim, bounds=base.bounds, cvnn=base.cvnn, lsmc_backward_version=recorded
    )
    assert expect_success(GbmCVNNPricer.create(fresh)).snapshot().lsmc_backward_version == 0


def test_create_pins_highest_matmul_precision() -> None:
    """GbmCVNNPricer.create applies the runtime policy: float32 matmuls run
    at 'highest' (no TF32), whatever the process default was."""
    import jax

    expect_success(GbmCVNNPricer.create(make_pricer_config()))
    assert jax.config.jax_default_matmul_precision == "highest"


@pytest.mark.parametrize("recorded", [0, 1, 2])
def test_checkpoint_still_decodes_removed_backward_versions(recorded: int) -> None:
    """ModelCheckpointProto keeps carrying lsmc_backward_version: versions of
    the removed fused backwards still decode (the mid-stream refusal above
    needs them), and the 0 default round-trips unchanged."""
    from spectralmc_tpu.serialization.converters import (
        checkpoint_from_proto,
        checkpoint_to_proto,
    )

    base = make_pricer_config()
    stamped = GbmCVNNPricerConfig(
        sim=base.sim, bounds=base.bounds, cvnn=base.cvnn, lsmc_backward_version=recorded
    )
    back = expect_success(checkpoint_from_proto(checkpoint_to_proto(stamped)))
    assert back.lsmc_backward_version == recorded
