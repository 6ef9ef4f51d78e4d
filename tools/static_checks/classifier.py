"""File-tier classifier.

The reference polices purity per *file tier* — Tier 2 business logic obeys
the strictest rules while Tier 3 GPU kernels are exempt
(``/root/reference/tools/check_purity.py`` file classifier;
``gbm.py:223`` boundary comment). The JAX build keeps the idea with tiers
matched to its own layer map (SURVEY §1):

* ``CORE``    — ``core/``: the functional kernel. Stdlib + pydantic only
  (the one sanctioned exception: ``core/precision.py`` holds the jnp dtype
  table). Strictest purity.
* ``KERNEL``  — jit-traced compute: ``ops/``, ``training/step.py``,
  ``parallel/``, ``models/cvnn.py``. Pure *as traced programs*: no host
  side effects, but jax idioms (loops over static structure) are fine.
* ``PURE``    — declarative config / chain logic: ``models/``,
  ``effects/types|composition|errors|mock``, ``storage/chain|verification``,
  ``training/trainer|effects_builders``. No I/O, no prints, no globals.
* ``ADAPTER`` — the impure boundary: ``runtime/``, ``storage/`` I/O,
  ``effects/interpreter|registry``, ``serialization/``, ``utils/``.
  Side effects allowed; hygiene rules (bare except, mutable defaults,
  annotations) still apply.
* ``CLI``     — ``__main__.py`` / ``test_runner.py``: may print.
"""

from __future__ import annotations

import enum
import fnmatch
from pathlib import Path


class Tier(enum.Enum):
    CORE = "core"
    KERNEL = "kernel"
    PURE = "pure"
    ADAPTER = "adapter"
    CLI = "cli"


# Ordered: first match wins. Patterns are relative to the repo root.
_TIER_PATTERNS: tuple[tuple[str, Tier], ...] = (
    ("spectralmc_tpu/storage/__main__.py", Tier.CLI),
    ("spectralmc_tpu/test_runner.py", Tier.CLI),
    ("spectralmc_tpu/core/*", Tier.CORE),
    ("spectralmc_tpu/core/errors/*", Tier.CORE),
    ("spectralmc_tpu/ops/*", Tier.KERNEL),
    ("spectralmc_tpu/training/step.py", Tier.KERNEL),
    # distributed.py wraps jax.distributed (process-global runtime init +
    # coordinator gating) — it is the multi-host impure boundary, like
    # runtime/jax_runtime.py, not traced compute.
    ("spectralmc_tpu/parallel/distributed.py", Tier.ADAPTER),
    ("spectralmc_tpu/parallel/*", Tier.KERNEL),
    ("spectralmc_tpu/models/cvnn.py", Tier.KERNEL),
    ("spectralmc_tpu/models/*", Tier.PURE),
    ("spectralmc_tpu/effects/types.py", Tier.PURE),
    ("spectralmc_tpu/effects/composition.py", Tier.PURE),
    ("spectralmc_tpu/effects/errors.py", Tier.PURE),
    ("spectralmc_tpu/effects/mock.py", Tier.PURE),
    ("spectralmc_tpu/storage/chain.py", Tier.PURE),
    ("spectralmc_tpu/storage/verification.py", Tier.PURE),
    ("spectralmc_tpu/training/trainer.py", Tier.PURE),
    ("spectralmc_tpu/training/effects_builders.py", Tier.PURE),
    ("spectralmc_tpu/*", Tier.ADAPTER),
)

# Sanctioned layering exceptions, path -> reason (documented, not silent).
JAX_IN_CORE_ALLOWED = {
    "spectralmc_tpu/core/precision.py": "Precision enum owns the jnp dtype table",
}


def classify(path: str | Path) -> Tier:
    """Classify a library file path (repo-root relative) into a tier."""
    rel = str(path).replace("\\", "/")
    # normalize absolute paths to repo-relative
    marker = "spectralmc_tpu/"
    idx = rel.find(marker)
    if idx > 0:
        rel = rel[idx:]
    for pattern, tier in _TIER_PATTERNS:
        if fnmatch.fnmatch(rel, pattern):
            return tier
    return Tier.ADAPTER
