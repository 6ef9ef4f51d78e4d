"""Precision policy — the single source of truth for dtypes.

Capability parity with ``/root/reference/src/spectralmc/models/numerical.py:124-183``
(``Precision`` enum with loss-free numpy/cupy maps and a float↔complex
bijection), re-designed for JAX:

* maps go to ``jnp``/``np`` dtypes (no CuPy — one framework);
* ``float64``/``complex128`` require ``jax_enable_x64``; requesting them
  without it is an explicit ``Failure`` rather than a silent downcast
  (JAX would otherwise quietly truncate to 32-bit);
* a *storage-only* reduced-precision tier (``bfloat16``/``float16``) mirrors
  the reference's ``ReducedPrecisionDType`` (models/torch.py:102-162): legal
  for checkpoint payloads and activations, illegal as a Monte-Carlo dtype.
"""

from __future__ import annotations

import enum
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from spectralmc_tpu.core.errors.precision import PrecisionError, X64Disabled
from spectralmc_tpu.core.result import Failure, Result, Success


class Precision(enum.Enum):
    """Full-precision dtypes legal for Monte-Carlo simulation and training."""

    float32 = "float32"
    float64 = "float64"
    complex64 = "complex64"
    complex128 = "complex128"

    # --- dtype maps (O(1), loss-free) -------------------------------------

    def to_jnp(self) -> jnp.dtype:
        return _JNP_MAP[self]

    def to_np(self) -> np.dtype:
        return _NP_MAP[self]

    @classmethod
    def from_np(cls, dtype: np.dtype) -> "Result[Precision, PrecisionError]":
        key = np.dtype(dtype).name
        try:
            return Success(cls(key))
        except ValueError:
            return Failure(PrecisionError(dtype=key, reason="not a full-precision dtype"))

    # --- float <-> complex bijection --------------------------------------

    def is_complex(self) -> bool:
        return self in (Precision.complex64, Precision.complex128)

    def to_complex(self) -> "Precision":
        return {
            Precision.float32: Precision.complex64,
            Precision.float64: Precision.complex128,
            Precision.complex64: Precision.complex64,
            Precision.complex128: Precision.complex128,
        }[self]

    def from_complex(self) -> "Precision":
        return {
            Precision.complex64: Precision.float32,
            Precision.complex128: Precision.float64,
            Precision.float32: Precision.float32,
            Precision.float64: Precision.float64,
        }[self]

    # --- platform validation ----------------------------------------------

    def validate_available(self) -> "Result[Precision, PrecisionError]":
        """Fail explicitly when a 64-bit dtype is requested without x64."""
        if self in (Precision.float64, Precision.complex128) and not jax.config.jax_enable_x64:
            return Failure(
                X64Disabled(
                    dtype=self.value,
                    reason="jax_enable_x64 is off; 64-bit dtypes would silently downcast",
                )
            )
        return Success(self)


_JNP_MAP = {
    Precision.float32: jnp.dtype("float32"),
    Precision.float64: jnp.dtype("float64"),
    Precision.complex64: jnp.dtype("complex64"),
    Precision.complex128: jnp.dtype("complex128"),
}

_NP_MAP = {
    Precision.float32: np.dtype("float32"),
    Precision.float64: np.dtype("float64"),
    Precision.complex64: np.dtype("complex64"),
    Precision.complex128: np.dtype("complex128"),
}


class ReducedPrecision(enum.Enum):
    """Storage/activation-only dtypes; never legal as an MC dtype.

    Mirrors the reference's ``ReducedPrecisionDType`` policy
    (models/torch.py:102-162). ``bfloat16`` is the JAX-native reduced type.
    """

    bfloat16 = "bfloat16"
    float16 = "float16"

    def to_jnp(self) -> jnp.dtype:
        return jnp.dtype(self.value)


AnyPrecision = Union[Precision, ReducedPrecision]


def real_dtype_of(precision: Precision) -> jnp.dtype:
    """The real dtype backing a (possibly complex) precision."""
    return precision.from_complex().to_jnp()
