"""Test hooks for the fused Pallas kernels (ops/gbm_pallas.py)."""

from __future__ import annotations

import contextlib
from typing import Iterator

import jax
import jax.numpy as jnp
import pytest

from spectralmc_tpu.ops import gbm_pallas


@contextlib.contextmanager
def zero_bits() -> Iterator[None]:
    """Every in-kernel draw yields all-zero bits (u1 = 2^-25, u2 = 0), so
    every path is the same deterministic path and closed forms or dynamic
    programs can replay it. JAX's caches are cleared on entry and exit so no
    zero-bit program outlives the block."""

    def zeros(k0: jax.Array, k1: jax.Array, x0: jax.Array, x1: jax.Array):
        return jnp.zeros_like(x0), jnp.zeros_like(x1)

    with pytest.MonkeyPatch.context() as mp:
        jax.clear_caches()
        mp.setattr(gbm_pallas, "threefry2x32", zeros)
        try:
            yield
        finally:
            jax.clear_caches()
