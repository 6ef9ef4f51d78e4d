"""Pure effect-description builders.

Parity: ``BlackScholes.build_simulation_effects`` (reference gbm.py:342-397)
and the trainer's ``build_training_step_effects`` / epoch / full-run builders
(gbm_trainer.py:906-1118, the 8-phase step description). The JAX step has
fewer phases because the device work is one fused program: sample+simulate+
FFT+update collapse into ``TrainSegment``; the stream-sync/DLPack phases have
no counterpart. Orchestration tests assert these structures with
``MockInterpreter`` — no device, no network.
"""

from __future__ import annotations

from spectralmc_tpu.effects.composition import EffectSequence, sequence_effects
from spectralmc_tpu.effects.types import (
    AdvanceCounter,
    CaptureCounters,
    CommitVersion,
    ComputeFFT,
    LogMessage,
    LogMetrics,
    SimulatePaths,
    TrainSegment,
    UpdateMetadata,
)
from spectralmc_tpu.ops.gbm import BlackScholesContract, SimulationParams


def build_simulation_effects(
    sim: SimulationParams, contract: BlackScholesContract, *, out_id: str = "payoffs"
) -> EffectSequence:
    """One MC pricing as data (parity: gbm.py:342-397)."""
    return sequence_effects(
        [
            SimulatePaths(
                spot=contract.spot,
                strike=contract.strike,
                maturity=contract.maturity,
                rate=contract.rate,
                div_yield=contract.div_yield,
                vol=contract.vol,
                timesteps=sim.timesteps,
                batches=sim.batches_per_mc_run,
                network_size=sim.network_size,
                seed=sim.mc_seed,
                counter=sim.skip,
                scheme=sim.scheme.value,
                normalization=sim.normalization.value,
                payoff=sim.payoff.value,
                model=sim.model.value,
                precision=sim.precision.value,
                antithetic=sim.antithetic,
                barrier_rel=sim.barrier_rel or 0.0,
                lsmc_basis_degree=sim.lsmc_basis_degree,
                lsmc_exercise_every=sim.lsmc_exercise_every,
                forward_start_step=sim.forward_start_step or 0,
                cliquet_reset_every=sim.cliquet_reset_every or 0,
                cliquet_floor=sim.cliquet_floor,
                cliquet_cap=sim.cliquet_cap,
                sampling=sim.sampling.value,
                term_vol=sim.term.vol_shape if sim.term else (),
                term_rate=sim.term.rate_shape if sim.term else (),
                term_div=sim.term.div_shape if sim.term else (),
                out_id=out_id,
            ),
            ComputeFFT(
                in_id=out_id,
                batches=sim.batches_per_mc_run,
                network_size=sim.network_size,
                out_id=out_id + "/spectrum",
            ),
            AdvanceCounter(stream="mc", by=1),
        ]
    )


def build_training_step_effects(
    *, step: int, batch_size: int, learning_rate: float
) -> EffectSequence:
    """One fused training batch as data (parity: gbm_trainer.py:906-1023)."""
    return sequence_effects(
        [
            TrainSegment(length=1, batch_size=batch_size, learning_rate=learning_rate),
            AdvanceCounter(stream="sobol", by=batch_size),
            AdvanceCounter(stream="mc", by=batch_size),
            UpdateMetadata(key="global_step", operation="increment", value=0),
            LogMetrics(step=step, metrics={}),
        ]
    )


def build_training_run_effects(
    *,
    num_batches: int,
    batch_size: int,
    learning_rate: float,
    commit_interval: int | None = None,
    final_commit: bool = False,
) -> EffectSequence:
    """A full run with interval/final checkpoint effects (gbm_trainer.py:1046-1118)."""
    effects: list[object] = [
        LogMessage(level="info", message=f"training run: {num_batches} batches"),
        CaptureCounters(out_id="counters/initial"),
    ]
    done = 0
    while done < num_batches:
        seg = (
            min(commit_interval, num_batches - done)
            if commit_interval is not None
            else num_batches
        )
        effects.append(
            TrainSegment(
                length=seg,
                batch_size=batch_size,
                learning_rate=learning_rate,
                commit_after=commit_interval is not None and seg == commit_interval,
            )
        )
        done += seg
        if commit_interval is not None and seg == commit_interval and not (
            done == num_batches and final_commit
        ):
            effects.append(
                CommitVersion(data_id="checkpoint", content_hash="", message=f"batch {done}")
            )
    if final_commit:
        effects.append(
            CommitVersion(data_id="checkpoint", content_hash="", message=f"final {done}")
        )
    effects.append(LogMessage(level="info", message="training run complete"))
    return sequence_effects(effects)  # type: ignore[arg-type]
