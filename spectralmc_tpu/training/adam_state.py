"""Typed, versioned Adam optimizer-state schema.

The reference mirrors torch Adam state field-by-field into named proto
messages (``/root/reference/src/spectralmc/models/torch.py:348-735`` —
``AdamParamState{exp_avg, exp_avg_sq, step}`` keyed by parameter). Round 1
serialized the raw optax state tree by positional path strings
("opt/0/.mu/..."), which silently breaks if optax reorders its state tuple
across versions. This module restores the reference's discipline, JAX-style:

* ``AdamStateSnapshot`` names the moments — ``mu``/``nu`` tensor maps keyed
  by the SAME parameter paths as ``model_state`` entries, plus the shared
  ``count`` scalar and an explicit ``schema_version``.
* Extraction/restoration locate the ``optax.ScaleByAdamState`` cell by TYPE,
  not by tuple position, so an optax chain reshuffle cannot silently
  mis-attach moments.
* ``migrate_legacy_flat`` upgrades round-1 positional checkpoints (one-time,
  loud on mismatch) — old checkpoints keep loading.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

from spectralmc_tpu.core.aliases import PyTree

import jax
import numpy as np
import optax

ADAM_SCHEMA_VERSION = 1

_LEGACY_COUNT_KEY = "opt/0/.count"
_LEGACY_MU_PREFIX = "opt/0/.mu/"
_LEGACY_NU_PREFIX = "opt/0/.nu/"


def param_path_keys(params: PyTree) -> list[str]:
    """Flatten param-tree paths with the scheme ``model_state`` uses (no prefix)."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return [
        "".join(
            f"/{p.key}" if hasattr(p, "key") else f"/{getattr(p, 'idx', p)}" for p in path
        ).lstrip("/")
        for path, _ in flat
    ]


def _flatten_by_param_path(tree: PyTree) -> dict[str, np.ndarray]:
    # leaves stay as-is (device arrays included): forcing np.asarray here
    # would host-transfer the whole Adam state on every training segment;
    # serialization converts lazily at checkpoint time.
    keys = param_path_keys(tree)
    leaves = jax.tree_util.tree_leaves(tree)
    return dict(zip(keys, leaves))


def _unflatten_like_params(template: PyTree, named: Mapping[str, np.ndarray]) -> PyTree:
    keys = param_path_keys(template)
    leaves_with_path, treedef = jax.tree_util.tree_flatten_with_path(template)
    new_leaves = []
    for key, (_, leaf) in zip(keys, leaves_with_path):
        if key not in named:
            raise KeyError(f"adam state missing moment for parameter {key!r}")
        import jax.numpy as jnp

        new_leaves.append(jnp.asarray(named[key], dtype=leaf.dtype).reshape(leaf.shape))
    return jax.tree_util.tree_unflatten(treedef, new_leaves)


@dataclass(frozen=True)
class AdamStateSnapshot:
    """Named Adam moments keyed by parameter path + the shared step count."""

    mu: Mapping[str, np.ndarray]
    nu: Mapping[str, np.ndarray]
    count: int
    schema_version: int = field(default=ADAM_SCHEMA_VERSION)

    def __post_init__(self) -> None:
        if set(self.mu) != set(self.nu):
            raise ValueError(
                f"mu/nu parameter sets differ: {sorted(set(self.mu) ^ set(self.nu))}"
            )
        if self.schema_version != ADAM_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported adam schema_version {self.schema_version} "
                f"(this build reads v{ADAM_SCHEMA_VERSION})"
            )


def _find_adam_cell(opt_state: PyTree) -> tuple[int, optax.ScaleByAdamState]:
    """Locate the ScaleByAdamState in an optax chain state BY TYPE."""
    cells = [
        (i, el) for i, el in enumerate(opt_state) if isinstance(el, optax.ScaleByAdamState)
    ]
    if len(cells) != 1:
        raise TypeError(
            f"expected exactly one ScaleByAdamState in the optimizer chain, "
            f"found {len(cells)} in {tuple(type(e).__name__ for e in opt_state)}"
        )
    return cells[0]


def snapshot_from_optax(opt_state: PyTree) -> AdamStateSnapshot:
    """Extract the named-moment snapshot from a live optax adam state."""
    _, cell = _find_adam_cell(opt_state)
    return AdamStateSnapshot(
        mu=_flatten_by_param_path(cell.mu),
        nu=_flatten_by_param_path(cell.nu),
        count=int(np.asarray(cell.count)),
    )


def restore_into_optax(fresh_opt_state: PyTree, snapshot: AdamStateSnapshot) -> PyTree:
    """Reattach checkpointed moments onto a freshly-initialized adam state.

    The fresh state supplies dtypes/shapes (it was initialized from the live
    params), so a checkpoint whose moment set doesn't match the model fails
    with a named KeyError rather than silently mis-assigning tensors.
    """
    index, cell = _find_adam_cell(fresh_opt_state)
    import jax.numpy as jnp

    restored = cell._replace(
        count=jnp.asarray(snapshot.count, dtype=np.asarray(cell.count).dtype),
        mu=_unflatten_like_params(cell.mu, snapshot.mu),
        nu=_unflatten_like_params(cell.nu, snapshot.nu),
    )

    def _rebuild(i: int, el: PyTree) -> PyTree:
        if i == index:
            return restored
        # lr schedules (optax.ScaleByScheduleState) track their position with
        # their own count, which steps in lockstep with Adam's — re-sync it
        # from the same snapshot count so resume ≡ continuous needs no extra
        # checkpoint state (training/step.py::LRScheduleConfig).
        if isinstance(el, optax.ScaleByScheduleState):
            return el._replace(
                count=jnp.asarray(snapshot.count, dtype=np.asarray(el.count).dtype)
            )
        return el

    return tuple(_rebuild(i, el) for i, el in enumerate(fresh_opt_state))


def migrate_legacy_flat(flat: Mapping[str, np.ndarray]) -> AdamStateSnapshot:
    """Upgrade a round-1 positional checkpoint map to the named schema.

    Legacy layout: ``opt/0/.count``, ``opt/0/.mu/<param-path>``,
    ``opt/0/.nu/<param-path>`` (positional on optax's historical
    ``(ScaleByAdamState, EmptyState)`` tuple). Raises KeyError when the map
    doesn't match that layout — a loud migration failure, never a guess.
    """
    if _LEGACY_COUNT_KEY not in flat:
        raise KeyError(
            f"legacy adam state missing {_LEGACY_COUNT_KEY!r}; keys={sorted(flat)[:5]}"
        )
    mu = {
        k[len(_LEGACY_MU_PREFIX):]: np.asarray(v)
        for k, v in flat.items()
        if k.startswith(_LEGACY_MU_PREFIX)
    }
    nu = {
        k[len(_LEGACY_NU_PREFIX):]: np.asarray(v)
        for k, v in flat.items()
        if k.startswith(_LEGACY_NU_PREFIX)
    }
    return AdamStateSnapshot(mu=mu, nu=nu, count=int(np.asarray(flat[_LEGACY_COUNT_KEY])))


def coerce_optimizer_state(
    state: "AdamStateSnapshot | Mapping[str, np.ndarray] | None",
) -> AdamStateSnapshot | None:
    """Accept either schema (typed v1 or legacy flat map) and return v1."""
    if state is None or isinstance(state, AdamStateSnapshot):
        return state
    return migrate_legacy_flat(state)
