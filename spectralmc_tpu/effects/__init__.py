"""Effect system: pure descriptions of orchestration, interpreted at the edge.

Capability parity with ``/root/reference/src/spectralmc/effects/`` (~3,000
LoC): 7 effect families as frozen dataclasses with ``kind`` discriminators, a
master ``Effect`` union, sequence/parallel composition with continuations, a
typed ``SharedRegistry`` data plane, an async interpreter per family routed by
``SpectralMCInterpreter``, and a recording ``MockInterpreter`` for
hardware-free orchestration tests (the reference's most test-valuable idea,
SURVEY §7 stage 10).

JAX redesign: the unit of device execution is the **jitted fused step**, not
8 interpreted micro-effects — so the MonteCarlo/Training effects describe
calls into the jitted programs (``JitCall``/``TrainSegment``), while the
reference's stream-sync and DLPack effects collapse (one framework, XLA async
dispatch). Storage/RNG/Metadata/Logging families carry over with the same
semantics.
"""

from spectralmc_tpu.effects.types import (
    AdvanceCounter,
    BlockUntilReady,
    CaptureCounters,
    CommitVersion,
    ComputeFFT,
    ComputeLoss,
    DeviceEffect,
    Effect,
    ForwardPass,
    GenerateNormals,
    GradientStep,
    HostDeviceTransfer,
    JitCall,
    LogMessage,
    LoggingEffect,
    LogMetrics,
    MetadataEffect,
    MonteCarloEffect,
    ReadMetadata,
    ReadObject,
    RestoreCounters,
    RngEffect,
    SimulatePaths,
    StorageEffect,
    TrainingEffect,
    TrainSegment,
    UpdateMetadata,
    WriteObject,
)
from spectralmc_tpu.effects.composition import (
    EffectParallel,
    EffectSequence,
    map_effect,
    parallel_effects,
    sequence_effects,
)
from spectralmc_tpu.effects.registry import FrozenRegistrySnapshot, SharedRegistry
from spectralmc_tpu.effects.interpreter import SpectralMCInterpreter
from spectralmc_tpu.effects.mock import MockInterpreter

__all__ = [
    "AdvanceCounter",
    "BlockUntilReady",
    "CaptureCounters",
    "CommitVersion",
    "ComputeFFT",
    "ComputeLoss",
    "DeviceEffect",
    "Effect",
    "EffectParallel",
    "EffectSequence",
    "ForwardPass",
    "FrozenRegistrySnapshot",
    "GenerateNormals",
    "GradientStep",
    "HostDeviceTransfer",
    "JitCall",
    "LogMessage",
    "LogMetrics",
    "LoggingEffect",
    "MetadataEffect",
    "MockInterpreter",
    "MonteCarloEffect",
    "ReadMetadata",
    "ReadObject",
    "RestoreCounters",
    "RngEffect",
    "SharedRegistry",
    "SimulatePaths",
    "SpectralMCInterpreter",
    "StorageEffect",
    "TrainSegment",
    "TrainingEffect",
    "UpdateMetadata",
    "WriteObject",
    "map_effect",
    "parallel_effects",
    "sequence_effects",
]
