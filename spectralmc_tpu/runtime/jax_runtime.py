"""Deterministic runtime configuration as data.

Parity: ``/root/reference/src/spectralmc/runtime/torch_runtime.py:23-99`` —
the reference probes CUDA/cuDNN readiness into a frozen ``TorchRuntime`` ADT,
applies deterministic flags exactly once (CUBLAS workspace, deterministic
algorithms, TF32 off), and caches the configured module handle.

JAX translation (SURVEY §2.9 N8): "apply" pins the *numerics-affecting*
knobs: the matmul precision default (``highest``: no implicit TF32 or bf16
passes for float32 inputs, as the reference turned TF32 off), float dtype
promotion discipline (x64 state recorded, not silently flipped), and
records the backend fingerprint for checkpoints. Kernel-selection flags
that affect run-to-run determinism on the GPU (``XLA_FLAGS``) belong to the
launchers, not to library code.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import contextlib
import os
from pathlib import Path
from typing import Iterator

import jax

_LOCK = threading.Lock()
_APPLIED: "JaxRuntime | None" = None


@dataclass(frozen=True, slots=True)
class JaxRuntime:
    """Probe result + the config that will be applied (pure data)."""

    backend: str
    device_kind: str
    device_count: int
    x64_enabled: bool
    matmul_precision: str = "highest"


def decide_jax_runtime(*, matmul_precision: str = "highest") -> JaxRuntime:
    """Probe the backend; no side effects."""
    devices = jax.devices()
    return JaxRuntime(
        backend=devices[0].platform,
        device_kind=getattr(devices[0], "device_kind", "unknown"),
        device_count=len(devices),
        x64_enabled=bool(jax.config.jax_enable_x64),
        matmul_precision=matmul_precision,
    )


def apply_jax_runtime(runtime: JaxRuntime) -> JaxRuntime:
    """Apply numerics policy exactly once (idempotent, thread-guarded).

    ``highest`` matmul precision disables implicit TF32/bf16 passes for f32
    inputs — the reference's TF32-off setting (torch_runtime.py:72-77).
    Library code still opts into lower precision explicitly where it wants
    it.
    """
    global _APPLIED
    with _LOCK:
        if _APPLIED is not None:
            return _APPLIED
        jax.config.update("jax_default_matmul_precision", runtime.matmul_precision)
        _APPLIED = runtime
        return runtime


def get_jax_handle() -> JaxRuntime:
    """Probe + apply + return the cached runtime (parity: get_torch_handle)."""
    with _LOCK:
        cached = _APPLIED
    if cached is not None:
        return cached
    return apply_jax_runtime(decide_jax_runtime())


CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# A fixed path inside the checkout: the path is part of the cache's key, so
# a directory that moves between runs never hits (listed in .gitignore).
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache(*, min_compile_time_secs: float = 1.0) -> str:
    """Turn on the persistent XLA compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is set here; otherwise the cache lives at the fixed
    ``<checkout>/.jax_cache``. Entry points (``bench.py``, ``chip_smoke.py``)
    call this — the library never does implicitly.
    """
    cache_dir = os.environ.get(CACHE_ENV) or str(DEFAULT_CACHE_DIR)
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_time_secs)
    return cache_dir


@contextlib.contextmanager
def device_scope(device: jax.Device) -> Iterator[None]:
    """Scoped default device (reference ``default_device`` context manager,
    models/torch.py:181-212). The reference needs a main-thread assertion
    because torch's default-device is process-global mutable state; jax's
    ``default_device`` is already thread-local, so the guard dissolves."""
    with jax.default_device(device):
        yield


@contextlib.contextmanager
def matmul_precision_scope(precision: str) -> Iterator[None]:
    """Scoped matmul precision ("default" | "high" | "highest") —
    the dtype-policy counterpart of the reference's ``default_dtype``."""
    with jax.default_matmul_precision(precision):
        yield
