"""Effect interpreters — the single impure boundary.

Parity: ``/root/reference/src/spectralmc/effects/interpreter.py:147-1284``:
one class per family, all ``async interpret(effect) -> Result``, routed by
``SpectralMCInterpreter`` which also runs fail-fast sequences (continuation
over results) and parallel gathers; a ``create`` factory wires a shared
registry. ``assert_never`` guards exhaustiveness.

JAX notes: the MonteCarlo interpreter executes the *real* XLA simulation ops
(as the reference's launches the real CUDA kernel, interpreter.py:645-654);
Device effects wrap host<->device movement and jitted-program calls;
GradientStep delegates to a registered fused update function (bwd+opt are one
traced program here, not separate effects).
"""

from __future__ import annotations

import asyncio
import logging
from typing import NoReturn

from spectralmc_tpu.core.aliases import EffectResult

import jax
import jax.numpy as jnp
import numpy as np

from spectralmc_tpu.core.result import Failure, Result, Success
from spectralmc_tpu.effects.composition import EffectParallel, EffectSequence, MappedEffect
from spectralmc_tpu.effects.errors import (
    DeviceError,
    EffectError,
    LoggingError,
    MetadataError,
    MonteCarloError,
    RNGError,
    StorageEffectError,
    TrainingError,
    UnknownEffect,
)
from spectralmc_tpu.effects.registry import SharedRegistry
from spectralmc_tpu.effects.types import (
    AdvanceCounter,
    BlockUntilReady,
    CaptureCounters,
    CommitVersion,
    ComputeFFT,
    ComputeLoss,
    Effect,
    ForwardPass,
    GenerateNormals,
    GradientStep,
    HostDeviceTransfer,
    JitCall,
    LogMessage,
    LogMetrics,
    ReadMetadata,
    ReadObject,
    RestoreCounters,
    SimulatePaths,
    TrainSegment,
    UpdateMetadata,
    WriteObject,
)

TENSORBOARD_WRITER_KEY = "_tensorboard_writer"


def assert_never(value: NoReturn) -> NoReturn:
    raise AssertionError(f"unhandled effect type: {type(value).__name__}")


class DeviceInterpreter:
    def __init__(self, registry: SharedRegistry) -> None:
        self._registry = registry

    async def interpret(self, effect: Effect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, HostDeviceTransfer):
            got = self._registry.get_array(effect.tensor_id)
            if isinstance(got, Failure):
                return Failure(DeviceError(effect_kind=effect.kind, reason=repr(got.error)))
            if effect.direction == "device_to_host":
                value = np.asarray(got.value)
            else:
                value = jax.device_put(got.value)
            self._registry.replace_array(effect.tensor_id, value)
            return Success(effect.tensor_id)
        if isinstance(effect, BlockUntilReady):
            got = self._registry.get_array(effect.tensor_id)
            if isinstance(got, Failure):
                return Failure(DeviceError(effect_kind=effect.kind, reason=repr(got.error)))
            jax.block_until_ready(got.value)
            return Success(effect.tensor_id)
        if isinstance(effect, JitCall):
            fn = self._registry.get_function(effect.fn_id)
            if isinstance(fn, Failure):
                return Failure(DeviceError(effect_kind=effect.kind, reason=repr(fn.error)))
            args = []
            for arg_id in effect.arg_ids:
                got = self._registry.get_array(arg_id)
                if isinstance(got, Failure):
                    return Failure(
                        DeviceError(effect_kind=effect.kind, reason=repr(got.error))
                    )
                args.append(got.value)
            try:
                out = fn.value(*args)
            except Exception as exc:  # noqa: BLE001 — traced-program failure
                return Failure(DeviceError(effect_kind=effect.kind, reason=str(exc)))
            if effect.out_id:
                self._registry.replace_array(effect.out_id, out)
            return Success(effect.out_id)
        assert_never(effect)


class MonteCarloInterpreter:
    def __init__(self, registry: SharedRegistry) -> None:
        self._registry = registry

    async def interpret(self, effect: Effect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, GenerateNormals):
            from spectralmc_tpu.ops.rng import base_key, normal_matrix

            matrix = normal_matrix(
                base_key(effect.seed), effect.counter, effect.rows, effect.cols, jnp.float32
            )
            put = self._registry.put_array(effect.out_id, matrix)
            if isinstance(put, Failure):
                return Failure(MonteCarloError(effect_kind=effect.kind, reason=repr(put.error)))
            return Success(effect.out_id)
        if isinstance(effect, SimulatePaths):
            from spectralmc_tpu.ops.gbm import (
                ModelKind,
                PathScheme,
                PayoffKind,
                expected_underlier_mean,
                simulate_underlier_rows,
                terminal_to_prices,
            )

            key = jax.random.fold_in(jax.random.PRNGKey(effect.seed), effect.counter)
            try:
                scheme = PathScheme(effect.scheme)
                payoff = PayoffKind(effect.payoff)
                model = ModelKind(effect.model)
                from spectralmc_tpu.core.precision import Precision
                from spectralmc_tpu.ops.gbm import SamplingKind

                dtype = Precision(effect.precision).to_jnp()
                sampling = SamplingKind(effect.sampling)
            except ValueError as exc:
                return Failure(
                    MonteCarloError(effect_kind=effect.kind, reason=f"bad enum value: {exc}")
                )
            if model != ModelKind.GBM:
                # Heston contracts carry 10 fields and baskets a static spec
                # that the effect's 6-field market record cannot express;
                # describe those runs via TrainSegment.
                return Failure(
                    MonteCarloError(
                        effect_kind=effect.kind,
                        reason="SimulatePaths carries BS market fields only (model=gbm)",
                    )
                )
            contract = jnp.array(
                [
                    effect.spot,
                    effect.strike,
                    effect.maturity,
                    effect.rate,
                    effect.div_yield,
                    effect.vol,
                ],
                dtype=dtype,
            )
            from spectralmc_tpu.ops.gbm import (
                AMERICAN_PAYOFFS,
                BARRIER_PAYOFFS,
                PayoffKind,
                has_closed_form_mean,
            )

            # mirror build_simulation_params' gates the effect route would
            # otherwise bypass: MEAN normalization needs a closed-form
            # E[underlier] (barrier/American kinds have none — the fallback
            # target would silently rescale to the WRONG mean), and the
            # American kinds need the log-Euler scheme + >= 2 monitor dates
            # (1 date is the European option mislabeled).
            if effect.normalization == "mean" and payoff == PayoffKind.DIGITAL:
                return Failure(
                    MonteCarloError(
                        effect_kind=effect.kind,
                        reason="the digital ±1 underlier encoding is not "
                        "scale-equivariant; use normalization='none'",
                    )
                )
            if effect.normalization == "mean" and not has_closed_form_mean(
                model, payoff
            ):
                return Failure(
                    MonteCarloError(
                        effect_kind=effect.kind,
                        reason=f"payoff={payoff.value!r} has no closed-form "
                        "E[underlier]; use normalization='none'",
                    )
                )
            if sampling == SamplingKind.SOBOL_BB:
                # mirror build_simulation_params' QMC gates
                if payoff in AMERICAN_PAYOFFS:
                    return Failure(
                        MonteCarloError(
                            effect_kind=effect.kind,
                            reason="LSMC early exercise draws its own pseudo "
                            "stream; QMC applies to path-independent payoffs",
                        )
                    )
                if effect.antithetic:
                    return Failure(
                        MonteCarloError(
                            effect_kind=effect.kind,
                            reason="antithetic mirroring breaks the Sobol net's "
                            "digital-shift randomization; choose one scheme",
                        )
                    )
            if payoff in AMERICAN_PAYOFFS:
                if scheme != PathScheme.LOG_EULER:
                    return Failure(
                        MonteCarloError(
                            effect_kind=effect.kind,
                            reason="LSMC early exercise is log-Euler only",
                        )
                    )
                every = effect.lsmc_exercise_every
                if every < 1 or effect.timesteps % every:
                    return Failure(
                        MonteCarloError(
                            effect_kind=effect.kind,
                            reason=f"lsmc_exercise_every={every} must divide "
                            f"timesteps={effect.timesteps}",
                        )
                    )
                if effect.timesteps // every < 2:
                    return Failure(
                        MonteCarloError(
                            effect_kind=effect.kind,
                            reason="early exercise needs >= 2 monitor dates",
                        )
                    )
            if payoff in BARRIER_PAYOFFS:
                if effect.barrier_rel <= 0.0:
                    return Failure(
                        MonteCarloError(
                            effect_kind=effect.kind,
                            reason=f"payoff={payoff.value!r} requires barrier_rel > 0",
                        )
                    )
                # mirror build_simulation_params' direction bounds: an up-out
                # level <= spot (or a down-out level >= spot) knocks every
                # path at step 1 and silently prices everything to zero
                if payoff == PayoffKind.BARRIER_UP_OUT and effect.barrier_rel <= 1.0:
                    return Failure(
                        MonteCarloError(
                            effect_kind=effect.kind,
                            reason="up-and-out barrier must be > 1x spot",
                        )
                    )
                if payoff == PayoffKind.BARRIER_DOWN_OUT and not (
                    0.0 < effect.barrier_rel < 1.0
                ):
                    return Failure(
                        MonteCarloError(
                            effect_kind=effect.kind,
                            reason="down-and-out barrier must be in (0, 1)x spot",
                        )
                    )
            if payoff == PayoffKind.FORWARD_START:
                # mirror build_simulation_params: the strike-setting date
                # must be an interior grid index
                if not (1 <= effect.forward_start_step < effect.timesteps):
                    return Failure(
                        MonteCarloError(
                            effect_kind=effect.kind,
                            reason="forward_start requires an interior "
                            f"forward_start_step (got {effect.forward_start_step} "
                            f"for timesteps={effect.timesteps})",
                        )
                    )
            elif effect.forward_start_step:
                return Failure(
                    MonteCarloError(
                        effect_kind=effect.kind,
                        reason=f"payoff={payoff.value!r} takes no "
                        "strike-setting date",
                    )
                )
            if payoff == PayoffKind.CLIQUET:
                # mirror build_simulation_params: reset grid + clip levels
                if (
                    effect.cliquet_reset_every <= 0
                    or effect.cliquet_floor is None
                    or effect.cliquet_cap is None
                ):
                    return Failure(
                        MonteCarloError(
                            effect_kind=effect.kind,
                            reason="cliquet requires cliquet_reset_every, "
                            "cliquet_floor and cliquet_cap",
                        )
                    )
                if (
                    effect.timesteps % effect.cliquet_reset_every
                    or effect.timesteps // effect.cliquet_reset_every < 2
                ):
                    return Failure(
                        MonteCarloError(
                            effect_kind=effect.kind,
                            reason="cliquet_reset_every must divide timesteps "
                            "with >= 2 reset periods",
                        )
                    )
                if not (-1.0 < effect.cliquet_floor < effect.cliquet_cap):
                    return Failure(
                        MonteCarloError(
                            effect_kind=effect.kind,
                            reason="need -1 < cliquet_floor < cliquet_cap",
                        )
                    )
                if effect.normalization == "mean":
                    return Failure(
                        MonteCarloError(
                            effect_kind=effect.kind,
                            reason="the cliquet clipped-return sum is not "
                            "scale-equivariant; use normalization='none'",
                        )
                    )
            elif (
                effect.cliquet_reset_every
                or effect.cliquet_floor is not None
                or effect.cliquet_cap is not None
            ):
                return Failure(
                    MonteCarloError(
                        effect_kind=effect.kind,
                        reason=f"payoff={payoff.value!r} takes no cliquet "
                        "reset grid or clip levels",
                    )
                )
            term = None
            if effect.term_vol or effect.term_rate or effect.term_div:
                # the model==GBM gate already returned above (SimulatePaths
                # carries BS market fields only); mirror the remaining
                # build_simulation_params term gates
                from spectralmc_tpu.ops.gbm import (
                    TermStructure,
                    validate_term_structure,
                )

                checked_term = validate_term_structure(
                    TermStructure(
                        vol_shape=effect.term_vol,
                        rate_shape=effect.term_rate,
                        div_shape=effect.term_div,
                    ),
                    timesteps=effect.timesteps,
                )
                if isinstance(checked_term, Failure):
                    return Failure(
                        MonteCarloError(
                            effect_kind=effect.kind,
                            reason=checked_term.error.reason,
                        )
                    )
                term = checked_term.value
            normalize = effect.normalization == "mean"
            rows = simulate_underlier_rows(
                key,
                contract,
                timesteps=effect.timesteps,
                rows=effect.batches,
                cols=effect.network_size,
                dtype=dtype,
                scheme=scheme,
                payoff=payoff,
                antithetic_half=effect.batches // 2 if effect.antithetic else None,
                barrier_rel=effect.barrier_rel if effect.barrier_rel > 0.0 else None,
                lsmc_basis_degree=effect.lsmc_basis_degree,
                lsmc_exercise_every=effect.lsmc_exercise_every,
                forward_start_step=effect.forward_start_step or None,
                cliquet_reset_every=effect.cliquet_reset_every or None,
                cliquet_floor=effect.cliquet_floor,
                cliquet_cap=effect.cliquet_cap,
                sampling=sampling,
                mc_seed=effect.seed,
                term=term,
            )
            prices = terminal_to_prices(
                rows.reshape(-1),
                contract,
                normalize=normalize,
                dtype=dtype,
                mean_target=expected_underlier_mean(
                    contract,
                    timesteps=effect.timesteps,
                    payoff=payoff,
                    dtype=dtype,
                    term=term,
                    forward_start_step=effect.forward_start_step or None,
                )
                if normalize
                else None,
                term=term,
            )
            put = self._registry.put_array(effect.out_id, prices.put_payoffs)
            if isinstance(put, Failure):
                return Failure(MonteCarloError(effect_kind=effect.kind, reason=repr(put.error)))
            return Success(effect.out_id)
        if isinstance(effect, ComputeFFT):
            from spectralmc_tpu.ops.spectrum import payoff_spectrum

            got = self._registry.get_array(effect.in_id)
            if isinstance(got, Failure):
                return Failure(MonteCarloError(effect_kind=effect.kind, reason=repr(got.error)))
            spectrum = payoff_spectrum(
                got.value, batches=effect.batches, network_size=effect.network_size
            )
            put = self._registry.put_array(effect.out_id, spectrum)
            if isinstance(put, Failure):
                return Failure(MonteCarloError(effect_kind=effect.kind, reason=repr(put.error)))
            return Success(effect.out_id)
        assert_never(effect)


class TrainingInterpreter:
    def __init__(self, registry: SharedRegistry) -> None:
        self._registry = registry

    async def interpret(self, effect: Effect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, ForwardPass):
            model = self._registry.get_model(effect.model_id)
            inputs = self._registry.get_array(effect.in_id)
            if isinstance(model, Failure) or isinstance(inputs, Failure):
                return Failure(TrainingError(effect_kind=effect.kind, reason="missing model/input"))
            bundle = model.value  # (cvnn, params, state)
            cvnn, params, state = bundle
            re = inputs.value
            out_re, out_im, _ = cvnn.apply(
                params, state, re, jnp.zeros_like(re), train=effect.train
            )
            self._registry.replace_array(effect.out_id + "/re", out_re)
            self._registry.replace_array(effect.out_id + "/im", out_im)
            return Success(effect.out_id)
        if isinstance(effect, ComputeLoss):
            pred = self._registry.get_array(effect.pred_id)
            target = self._registry.get_array(effect.target_id)
            if isinstance(pred, Failure) or isinstance(target, Failure):
                return Failure(TrainingError(effect_kind=effect.kind, reason="missing pred/target"))
            diff = pred.value - target.value
            if effect.loss_type == "mse":
                loss = jnp.mean(jnp.square(jnp.abs(diff)))
            elif effect.loss_type == "mae":
                loss = jnp.mean(jnp.abs(diff))
            else:  # huber
                a = jnp.abs(diff)
                loss = jnp.mean(jnp.where(a < 1.0, 0.5 * a * a, a - 0.5))
            self._registry.replace_array(effect.out_id, loss)
            return Success(effect.out_id)
        if isinstance(effect, (GradientStep, TrainSegment)):
            fn_id = "train_segment" if isinstance(effect, TrainSegment) else "gradient_step"
            fn = self._registry.get_function(fn_id)
            if isinstance(fn, Failure):
                return Failure(
                    TrainingError(
                        effect_kind=effect.kind,
                        reason=f"no registered function {fn_id!r}",
                    )
                )
            try:
                out = fn.value(effect)
            except Exception as exc:  # noqa: BLE001
                return Failure(TrainingError(effect_kind=effect.kind, reason=str(exc)))
            return Success(out)
        if isinstance(effect, LogMetrics):
            writer = self._registry.get_model(TENSORBOARD_WRITER_KEY)
            if isinstance(writer, Success):
                for name, value in (effect.metrics or {}).items():
                    writer.value.add_scalar(name, value, effect.step)
            logging.getLogger("spectralmc_tpu.metrics").info(
                "step=%d %s", effect.step, dict(effect.metrics or {})
            )
            return Success(effect.step)
        assert_never(effect)


class StorageInterpreter:
    def __init__(self, registry: SharedRegistry, store: "object | None") -> None:
        self._registry = registry
        self._store = store  # AsyncBlockchainModelStore

    async def interpret(self, effect: Effect) -> Result[EffectResult, EffectError]:
        if self._store is None:
            return Failure(
                StorageEffectError(effect_kind=effect.kind, reason="no store configured")
            )
        if isinstance(effect, ReadObject):
            got = await self._store.object_store.get(effect.key)
            if isinstance(got, Failure):
                return Failure(StorageEffectError(effect_kind=effect.kind, reason=repr(got.error)))
            self._registry.put_blob(effect.out_id, got.value[0])
            return Success(effect.out_id)
        if isinstance(effect, WriteObject):
            blob = self._registry.get_blob(effect.data_id)
            if isinstance(blob, Failure):
                return Failure(StorageEffectError(effect_kind=effect.kind, reason=repr(blob.error)))
            put = await self._store.object_store.put(effect.key, blob.value)
            if isinstance(put, Failure):
                return Failure(StorageEffectError(effect_kind=effect.kind, reason=repr(put.error)))
            return Success(effect.key)
        if isinstance(effect, CommitVersion):
            blob = self._registry.get_blob(effect.data_id)
            if isinstance(blob, Failure):
                return Failure(StorageEffectError(effect_kind=effect.kind, reason=repr(blob.error)))
            committed = await self._store.commit(blob.value, effect.content_hash, effect.message)
            if isinstance(committed, Failure):
                return Failure(
                    StorageEffectError(effect_kind=effect.kind, reason=repr(committed.error))
                )
            return Success(committed.value)
        assert_never(effect)


class RNGInterpreter:
    """Counters live in registry metadata — the whole RNG state (stateless keys)."""

    def __init__(self, registry: SharedRegistry) -> None:
        self._registry = registry

    async def interpret(self, effect: Effect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, CaptureCounters):
            sobol = self._registry.get_metadata("sobol_skip")
            mc = self._registry.get_metadata("mc_skip")
            snapshot = {
                "sobol_skip": sobol.value if isinstance(sobol, Success) else 0,
                "mc_skip": mc.value if isinstance(mc, Success) else 0,
            }
            return Success(snapshot)
        if isinstance(effect, RestoreCounters):
            self._registry.update_metadata("sobol_skip", "set", effect.sobol_skip)
            self._registry.update_metadata("mc_skip", "set", effect.mc_skip)
            return Success(None)
        if isinstance(effect, AdvanceCounter):
            key = "sobol_skip" if effect.stream == "sobol" else "mc_skip"
            result = self._registry.update_metadata(key, "add", effect.by)
            if isinstance(result, Failure):
                return Failure(RNGError(effect_kind=effect.kind, reason=repr(result.error)))
            return Success(result.value)
        assert_never(effect)


class MetadataInterpreter:
    def __init__(self, registry: SharedRegistry) -> None:
        self._registry = registry

    async def interpret(self, effect: Effect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, ReadMetadata):
            got = self._registry.get_metadata(effect.key)
            if isinstance(got, Failure):
                return Failure(MetadataError(effect_kind=effect.kind, reason=repr(got.error)))
            return Success(got.value)
        if isinstance(effect, UpdateMetadata):
            result = self._registry.update_metadata(effect.key, effect.operation, effect.value)
            if isinstance(result, Failure):
                return Failure(MetadataError(effect_kind=effect.kind, reason=repr(result.error)))
            return Success(result.value)
        assert_never(effect)


class LoggingInterpreter:
    async def interpret(self, effect: Effect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, LogMessage):
            logger = logging.getLogger(effect.logger)
            level = getattr(logging, effect.level.upper(), None)
            if level is None:
                return Failure(
                    LoggingError(effect_kind=effect.kind, reason=f"bad level {effect.level}")
                )
            logger.log(level, effect.message)
            return Success(None)
        assert_never(effect)


class SpectralMCInterpreter:
    """Routes the master union; runs sequences (fail-fast) and parallels."""

    def __init__(self, registry: SharedRegistry | None = None, store: "object | None" = None) -> None:
        self.registry = registry if registry is not None else SharedRegistry()
        self._device = DeviceInterpreter(self.registry)
        self._montecarlo = MonteCarloInterpreter(self.registry)
        self._training = TrainingInterpreter(self.registry)
        self._storage = StorageInterpreter(self.registry, store)
        self._rng = RNGInterpreter(self.registry)
        self._metadata = MetadataInterpreter(self.registry)
        self._logging = LoggingInterpreter()

    @classmethod
    def create(cls, *, store: "object | None" = None) -> "SpectralMCInterpreter":
        return cls(SharedRegistry(), store)

    async def interpret(self, effect: Effect | MappedEffect) -> Result[EffectResult, EffectError]:
        if isinstance(effect, MappedEffect):
            inner = await self.interpret(effect.effect)
            if isinstance(inner, Failure):
                return inner
            return Success(effect.fn(inner.value))
        kind = getattr(effect, "kind", None)
        if kind in ("host_device_transfer", "block_until_ready", "jit_call"):
            return await self._device.interpret(effect)
        if kind in ("generate_normals", "simulate_paths", "compute_fft"):
            return await self._montecarlo.interpret(effect)
        if kind in (
            "forward_pass",
            "compute_loss",
            "gradient_step",
            "train_segment",
            "log_metrics",
        ):
            return await self._training.interpret(effect)
        if kind in ("read_object", "write_object", "commit_version"):
            return await self._storage.interpret(effect)
        if kind in ("capture_counters", "restore_counters", "advance_counter"):
            return await self._rng.interpret(effect)
        if kind in ("read_metadata", "update_metadata"):
            return await self._metadata.interpret(effect)
        if kind == "log_message":
            return await self._logging.interpret(effect)
        return Failure(UnknownEffect(type_name=type(effect).__name__))

    async def interpret_sequence(
        self, sequence: EffectSequence
    ) -> Result[EffectResult, EffectError]:
        results: list[EffectResult] = []
        for effect in sequence.effects:
            result = await self.interpret(effect)
            if isinstance(result, Failure):
                return result  # fail-fast
            results.append(result.value)
        if sequence.continuation is not None:
            return Success(sequence.continuation(tuple(results)))
        return Success(tuple(results))

    async def interpret_parallel(self, parallel: EffectParallel) -> Result[EffectResult, EffectError]:
        results = await asyncio.gather(*(self.interpret(e) for e in parallel.effects))
        for result in results:
            if isinstance(result, Failure):
                return result
        values = tuple(r.value for r in results)
        if parallel.combiner is not None:
            return Success(parallel.combiner(values))
        return Success(values)
