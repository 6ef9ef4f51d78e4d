"""Host<->device tensor-tree transfer: pure plan -> execute split.

Parity: ``/root/reference/src/spectralmc/models/cpu_gpu_transfer.py:62-526``
— placement ADTs, a decision ADT (Stay/Direct/Reject), a host-transfer size
cap, and recursive moves over lists/tuples/mappings, plus the
device/dtype-uniqueness inspectors used to validate state dicts.

JAX simplifications: XLA manages pinned staging internally, so the
reference's ``StageThenCopy``-through-pinned-memory decision collapses into
``DirectTransfer`` (``jax.device_put`` is already asynchronous and staged);
streams don't exist (single async domain).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Union

import jax
import numpy as np

from spectralmc_tpu.core.result import Failure, Result, Success

# 64 MiB host-transfer cap, as the reference (cpu_gpu_transfer.py)
DEFAULT_HOST_TRANSFER_CAP_BYTES = 64 * 1024 * 1024

DeviceTree = Any  # nested lists/tuples/dicts of arrays


@dataclass(frozen=True, slots=True)
class HostPlacement:
    pass


@dataclass(frozen=True, slots=True)
class DevicePlacement:
    device_kind: str
    device_index: int = 0


Placement = Union[HostPlacement, DevicePlacement]


@dataclass(frozen=True, slots=True)
class StayOnPlacement:
    reason: str


@dataclass(frozen=True, slots=True)
class DirectTransfer:
    total_bytes: int


@dataclass(frozen=True, slots=True)
class RejectTransfer:
    reason: str
    total_bytes: int = 0


TransferDecision = Union[StayOnPlacement, DirectTransfer, RejectTransfer]


def _leaf_bytes(leaf: DeviceTree) -> int:
    arr = np.asarray(leaf) if not isinstance(leaf, jax.Array) else leaf
    return int(np.prod(arr.shape)) * arr.dtype.itemsize if arr.ndim else arr.dtype.itemsize


def _leaf_placement(leaf: DeviceTree) -> Placement:
    if isinstance(leaf, jax.Array):
        try:
            device = next(iter(leaf.devices()))
        except Exception:  # committed-less tracer etc.
            return HostPlacement()
        if device.platform == "cpu":
            return HostPlacement()
        return DevicePlacement(device_kind=device.platform, device_index=device.id)
    return HostPlacement()


def get_tree_placement(tree: DeviceTree) -> Result[tuple[Placement, str], str]:
    """(placement, dtype) of a tree, failing on mixed placement/dtype.

    Parity: ``get_tree_device_dtype`` / ``module_state_device_dtype``
    (cpu_gpu_transfer.py:460-526) — used to validate that a state dict is
    uniform before training starts.
    """
    leaves = jax.tree_util.tree_leaves(tree)
    if not leaves:
        return Failure("empty tree")
    placements = {repr(_leaf_placement(leaf)) for leaf in leaves}
    dtypes = {str(np.asarray(leaf).dtype if not isinstance(leaf, jax.Array) else leaf.dtype)
              for leaf in leaves}
    if len(placements) > 1:
        return Failure(f"mixed placements: {sorted(placements)}")
    if len(dtypes) > 1:
        return Failure(f"mixed dtypes: {sorted(dtypes)}")
    return Success((_leaf_placement(leaves[0]), next(iter(dtypes))))


def plan_tensor_transfer(
    tree: DeviceTree,
    target: Placement,
    *,
    host_cap_bytes: int = DEFAULT_HOST_TRANSFER_CAP_BYTES,
) -> TransferDecision:
    """Pure planning: no data moves here."""
    leaves = jax.tree_util.tree_leaves(tree)
    if not leaves:
        return RejectTransfer(reason="empty tree")
    total = sum(_leaf_bytes(leaf) for leaf in leaves)
    current = _leaf_placement(leaves[0])
    if repr(current) == repr(target):
        return StayOnPlacement(reason="already on target placement")
    if isinstance(target, HostPlacement) and total > host_cap_bytes:
        return RejectTransfer(
            reason=f"host transfer {total} bytes exceeds cap {host_cap_bytes}",
            total_bytes=total,
        )
    return DirectTransfer(total_bytes=total)


def move_tensor_tree(
    tree: DeviceTree,
    target: Placement,
    *,
    host_cap_bytes: int = DEFAULT_HOST_TRANSFER_CAP_BYTES,
) -> Result[DeviceTree, RejectTransfer]:
    """Plan, then execute the move (async under the hood; XLA stages)."""
    decision = plan_tensor_transfer(tree, target, host_cap_bytes=host_cap_bytes)
    if isinstance(decision, RejectTransfer):
        return Failure(decision)
    if isinstance(decision, StayOnPlacement):
        return Success(tree)
    if isinstance(target, HostPlacement):
        moved = jax.tree_util.tree_map(lambda leaf: np.asarray(leaf), tree)
    else:
        devices = [d for d in jax.devices() if d.platform == target.device_kind]
        if not devices:
            return Failure(
                RejectTransfer(reason=f"no {target.device_kind} devices available")
            )
        device = devices[min(target.device_index, len(devices) - 1)]
        moved = jax.tree_util.tree_map(lambda leaf: jax.device_put(leaf, device), tree)
    return Success(moved)
