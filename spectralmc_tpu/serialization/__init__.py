"""Checkpoint wire format: pytree/config <-> protobuf converters.

Capability parity with ``/root/reference/src/spectralmc/serialization/``
(TensorStateConverter, AdamOptimizerStateConverter, RNGStateConverter,
ModelCheckpointConverter, enum/config converters, compute_sha256) — including
the **complete recursive LayerCfg oneof** the reference left unfinished
(serialization/models.py:150 "simplified for now").

JAX redesign: model and optimizer states are flat path→tensor maps (pytrees
flatten losslessly, trainer.flatten_pytree), so the reference's bespoke Adam
proto tree disappears; RNG byte blobs become the integer counters already in
``SimulationParamsProto``/``sobol_skip``.
"""

from spectralmc_tpu.serialization.converters import (
    checkpoint_from_proto,
    checkpoint_to_proto,
    compute_sha256,
    cvnn_config_from_proto,
    cvnn_config_to_proto,
    deserialize_checkpoint,
    jax_env_snapshot,
    serialize_checkpoint,
    sim_params_from_proto,
    sim_params_to_proto,
    tensor_from_proto,
    tensor_map_from_proto,
    tensor_map_to_proto,
    tensor_to_proto,
    training_config_from_proto,
    training_config_to_proto,
    verify_checksum,
)

__all__ = [
    "checkpoint_from_proto",
    "checkpoint_to_proto",
    "compute_sha256",
    "cvnn_config_from_proto",
    "cvnn_config_to_proto",
    "deserialize_checkpoint",
    "jax_env_snapshot",
    "serialize_checkpoint",
    "sim_params_from_proto",
    "sim_params_to_proto",
    "tensor_from_proto",
    "tensor_map_from_proto",
    "tensor_map_to_proto",
    "tensor_to_proto",
    "training_config_from_proto",
    "training_config_to_proto",
    "verify_checksum",
]
