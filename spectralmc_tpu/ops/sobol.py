"""Pure-JAX scrambled Sobol quasi-random sampler.

Capability parity with the reference's SciPy-backed ``SobolSampler``
(``/root/reference/src/spectralmc/sobol_sampler.py:64-255``): scrambled Sobol
points with deterministic seeding, ``fast_forward``-style resume via a skip
counter, bound scaling over the fields of a pydantic model, and exact
field-set validation of the domain bounds.

JAX-first redesign: instead of calling a host CPU library per batch, direction
numbers are precomputed once (host, numpy, from the public Joe-Kuo
"new-joe-kuo-6" seed data embedded in ``_sobol_directions.py``) and points are
generated **on device** with pure ``uint32`` bit arithmetic — XOR-folding
Gray-code-indexed direction numbers — so contract sampling lives *inside* the
jitted train step with a traced start index. Scrambling is Owen-style linear
matrix scramble (LMS) + digital shift, applied to the direction numbers at
init so the per-point cost is unchanged.

The generated sequence (unscrambled) is bit-identical to SciPy's
``Sobol(d, scramble=False)`` at 30-bit resolution, which the tests assert.
"""

from __future__ import annotations

from typing import Generic, Mapping, Type, TypeVar

import jax
import jax.numpy as jnp
import numpy as np
from pydantic import BaseModel, ConfigDict

from spectralmc_tpu.core.errors.sobol import (
    BoundsFieldMismatch,
    DimensionTooLarge,
    InvalidBounds,
    InvalidSkip,
    SobolError,
)
from spectralmc_tpu.core.result import Failure, Result, Success
from spectralmc_tpu.ops._sobol_directions import MAX_DIMENSION, M_INIT, POLY

BITS = 32

TModel = TypeVar("TModel", bound=BaseModel)


# --------------------------------------------------------------------------
# Direction numbers (host-side, once per sampler)
# --------------------------------------------------------------------------


def direction_numbers(dimension: int) -> np.ndarray:
    """``[dimension, BITS]`` uint32 direction numbers V_k = m_k << (BITS - k).

    Standard Joe-Kuo recurrence; dimension 0 is the van der Corput sequence
    (all m_k = 1).
    """
    if dimension > MAX_DIMENSION:
        raise ValueError(f"dimension {dimension} > MAX_DIMENSION {MAX_DIMENSION}")
    v = np.zeros((dimension, BITS), dtype=np.uint64)
    for j in range(dimension):
        poly = POLY[j]
        s = max(poly.bit_length() - 1, 0)
        if s == 0:  # first dimension: van der Corput
            m = [1] * BITS
        else:
            m = list(M_INIT[j][:s])
            # interior coefficients a_1..a_{s-1} of the primitive polynomial
            a = (poly - (1 << s) - 1) >> 1
            for k in range(s, BITS):
                new = m[k - s] ^ (m[k - s] << s)
                for i in range(1, s):
                    if (a >> (s - 1 - i)) & 1:
                        new ^= m[k - i] << i
                m.append(new)
        for k in range(BITS):
            v[j, k] = np.uint64(m[k]) << np.uint64(BITS - 1 - k)
    return v.astype(np.uint32)


def _lms_scramble(
    v: np.ndarray, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Owen linear-matrix-scramble of direction numbers + digital shift.

    For each dimension draw a random lower-triangular (MSB-first) bit matrix L
    with unit diagonal and set V'_k = L·V_k over GF(2); since Sobol points are
    XORs of direction numbers, scrambling the table once scrambles every
    point. Returns (scrambled ``[d, BITS]`` uint32, shift ``[d]`` uint32).
    """
    d = v.shape[0]
    # bits[j, i, k] = bit i (MSB-first) of V_k for dimension j
    shifts = np.arange(BITS - 1, -1, -1, dtype=np.uint32)  # bit 0 of axis = MSB
    vbits = ((v[:, None, :] >> shifts[None, :, None]) & 1).astype(np.uint8)
    # Lower-triangular L in MSB-first indexing, unit diagonal.
    lmat = np.tril(rng.integers(0, 2, size=(d, BITS, BITS), dtype=np.uint8), k=-1)
    lmat |= np.eye(BITS, dtype=np.uint8)[None, :, :]
    ybits = (lmat @ vbits) & 1  # [d, BITS, BITS] GF(2) matvec per direction number
    weights = (np.uint32(1) << shifts).astype(np.uint32)
    scrambled = np.einsum("dik,i->dk", ybits.astype(np.uint64), weights.astype(np.uint64))
    shift = rng.integers(0, 1 << 32, size=(d,), dtype=np.uint32)
    return scrambled.astype(np.uint32), shift


# --------------------------------------------------------------------------
# Device-side point generation (jit-safe, traced start index)
# --------------------------------------------------------------------------


# Split-table block size: point index n is split as n = blk·2^L + j. The
# XOR-selector gray(n) then factors exactly (Sobol points are GF(2)-linear
# in the selector): the low-L direction columns contribute a [2^L, d]
# gray-ordered table, the high columns one combination per BLOCK
# (count/2^L of them), and the seam bit L-1 one conditional XOR of a single
# direction column. The full [count, d] point matrix is then a broadcast
# XOR of the two tables — O(count·d) work instead of the O(count·d·BITS)
# masked reduce round 3 used per point (measured 59% of the whole QMC
# sampling cost at 2M paths x 64 dims; docs/performance.md QMC section).
_SPLIT_LOG2 = 10


def _gray_select(
    directions: jax.Array, codes: jax.Array, nbits: int, bit_offset: int
) -> jax.Array:
    """``[m, d]`` XOR of direction columns selected by each code's low bits.

    ``codes`` is ``[m]`` uint32; bit k of a code selects
    ``directions[:, bit_offset + k]`` (k < nbits). The masked multi-output
    reduction is only ever applied to SMALL ``m`` (the split tables), never
    per point; XOR associativity keeps any reduction order bit-identical.
    """
    ks = jnp.arange(nbits, dtype=jnp.uint32)
    b = (codes[:, None] >> ks[None, :]) & jnp.uint32(1)  # [m, nbits]
    masks = jnp.uint32(0) - b  # 0x0 or 0xFFFFFFFF
    cols = directions[None, :, bit_offset : bit_offset + nbits]  # [1, d, nbits]
    terms = masks[:, None, :] & cols  # [m, d, nbits]
    return jax.lax.reduce(terms, jnp.uint32(0), jax.lax.bitwise_xor, (2,))


def sobol_uint32(
    directions: jax.Array, shift: jax.Array, start: jax.Array | int, count: int
) -> jax.Array:
    """Raw scrambled Sobol points as ``[count, d]`` uint32 fractions.

    ``directions`` is ``[d, BITS]`` uint32, ``shift`` ``[d]`` uint32, ``start``
    may be traced. Point ``n`` = XOR of direction numbers selected by the bits
    of gray(n), XOR the digital shift — pure vector integer work,
    assembled from the split tables (``_SPLIT_LOG2`` note above) so the
    per-point cost is ONE broadcast XOR. Bit-identical to the direct
    selector reduce for every (start, count): the split is exact GF(2)
    algebra, pinned against SciPy in ``tests/test_sobol.py``.

    The seam term: with n = blk·2^L + j (j < 2^L),
    ``gray(n) >> L == gray(blk)`` and
    ``gray(n) & (2^L-1) == (gray(j) & (2^L-1)) ^ ((blk & 1) << (L-1))`` —
    the block's low bit leaks into the top low-table bit, contributing one
    conditional XOR of ``directions[:, L-1]`` per block. A traced or
    misaligned ``start`` computes the covering aligned range and
    dynamic-slices the requested window (one extra block of points at
    worst); a static aligned start (the dispatch default, start=0) skips
    the slice entirely.
    """
    length = 1 << _SPLIT_LOG2
    mask = length - 1
    d = directions.shape[0]
    static_aligned = isinstance(start, int) and start % length == 0
    if static_aligned:
        blk0 = jnp.uint32(start >> _SPLIT_LOG2)
        n_blocks = -(-count // length)
        offset: jax.Array | None = None
    else:
        start_u = jnp.asarray(start, jnp.uint32)
        blk0 = start_u >> jnp.uint32(_SPLIT_LOG2)
        offset = start_u & jnp.uint32(mask)
        # worst-case misalignment needs ceil((mask + count) / length) blocks
        # (dynamic_slice CLAMPS out-of-range starts, so undershooting here
        # would silently return wrong points, not raise)
        n_blocks = (count + 2 * mask) // length
    j = jnp.arange(length, dtype=jnp.uint32)
    y_lo = _gray_select(directions, j ^ (j >> 1), _SPLIT_LOG2, 0)  # [2^L, d]
    blk = blk0 + jnp.arange(n_blocks, dtype=jnp.uint32)
    gray_blk = blk ^ (blk >> 1)
    c_hi = _gray_select(directions, gray_blk, BITS - _SPLIT_LOG2, _SPLIT_LOG2)
    seam = (jnp.uint32(0) - (blk & jnp.uint32(1)))[:, None] & directions[
        None, :, _SPLIT_LOG2 - 1
    ].reshape(1, d)
    c_hi = c_hi ^ seam ^ shift[None, :]  # [n_blocks, d]
    bits = c_hi[:, None, :] ^ y_lo[None, :, :]  # [n_blocks, 2^L, d]
    flat = bits.reshape(n_blocks * length, d)
    if offset is None:
        return flat[:count]
    return jax.lax.dynamic_slice(flat, (offset, jnp.uint32(0)), (count, d))


def sobol_uint32_t(
    directions: jax.Array, shift: jax.Array, start: jax.Array | int, count: int
) -> jax.Array:
    """``[d, count]`` TRANSPOSED scrambled Sobol points — the same bits as
    ``sobol_uint32(...)`` point for point, generated directly in the
    dimension-major orientation.

    Layout rationale: in the ``[count, d]`` orientation the minor axis is
    the dimension count (64 at the QMC cap), so every elementwise op
    downstream (the uint32→float map, ``ndtri``) walks short rows. Putting
    the POINT axis minor keeps accesses contiguous, and the Brownian-bridge contraction
    becomes a plain ``[T, d] @ [d, count]`` matmul with no input transpose
    (ops/qmc.py). Both orientations share the split-table algebra above.
    """
    length = 1 << _SPLIT_LOG2
    mask = length - 1
    d = directions.shape[0]
    static_aligned = isinstance(start, int) and start % length == 0
    if static_aligned:
        blk0 = jnp.uint32(start >> _SPLIT_LOG2)
        n_blocks = -(-count // length)
        offset: jax.Array | None = None
    else:
        start_u = jnp.asarray(start, jnp.uint32)
        blk0 = start_u >> jnp.uint32(_SPLIT_LOG2)
        offset = start_u & jnp.uint32(mask)
        # see sobol_uint32: undershooting block count silently clamps
        n_blocks = (count + 2 * mask) // length
    j = jnp.arange(length, dtype=jnp.uint32)
    y_lo = _gray_select(directions, j ^ (j >> 1), _SPLIT_LOG2, 0)  # [2^L, d]
    blk = blk0 + jnp.arange(n_blocks, dtype=jnp.uint32)
    gray_blk = blk ^ (blk >> 1)
    c_hi = _gray_select(directions, gray_blk, BITS - _SPLIT_LOG2, _SPLIT_LOG2)
    seam = (jnp.uint32(0) - (blk & jnp.uint32(1)))[:, None] & directions[
        None, :, _SPLIT_LOG2 - 1
    ].reshape(1, d)
    c_hi_t = (c_hi ^ seam ^ shift[None, :]).T  # [d, n_blocks]
    bits = c_hi_t[:, :, None] ^ y_lo.T[:, None, :]  # [d, n_blocks, 2^L]
    flat = bits.reshape(d, n_blocks * length)
    if offset is None:
        return flat[:, :count]
    return jax.lax.dynamic_slice(flat, (jnp.uint32(0), offset), (d, count))


def sobol_unit(
    directions: jax.Array,
    shift: jax.Array,
    start: jax.Array | int,
    count: int,
    dtype: jnp.dtype = jnp.float32,
) -> jax.Array:
    """Scrambled Sobol points in [0, 1) as ``[count, d]`` floats."""
    bits = sobol_uint32(directions, shift, start, count)
    if jnp.dtype(dtype) == jnp.dtype(jnp.float64):
        return bits.astype(jnp.float64) * jnp.float64(2.0**-32)
    # float32: keep the top 24 bits so the mantissa is exact and u < 1.
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2.0**-24)


def scale_to_bounds(unit: jax.Array, lower: jax.Array, upper: jax.Array) -> jax.Array:
    """Affine map of unit-cube points into per-column [lower, upper) bounds."""
    return lower[None, :] + unit * (upper - lower)[None, :]


# --------------------------------------------------------------------------
# Typed sampler over a pydantic model (host API, parity with the reference)
# --------------------------------------------------------------------------


class BoundSpec(BaseModel):
    model_config = ConfigDict(frozen=True, extra="forbid")
    lower: float
    upper: float


def build_bound_spec(lower: float, upper: float) -> Result[BoundSpec, SobolError]:
    if not (np.isfinite(lower) and np.isfinite(upper)):
        return Failure(InvalidBounds(field="", lower=lower, upper=upper, reason="non-finite bound"))
    if lower >= upper:
        return Failure(
            InvalidBounds(field="", lower=lower, upper=upper, reason="lower must be < upper")
        )
    return Success(BoundSpec(lower=lower, upper=upper))


class DomainBounds(BaseModel):
    """Field-name → BoundSpec map; must exactly cover the target model's fields."""

    model_config = ConfigDict(frozen=True, extra="forbid")
    bounds: Mapping[str, BoundSpec]


def build_domain_bounds(
    model_cls: Type[BaseModel], bounds: Mapping[str, BoundSpec]
) -> Result[DomainBounds, SobolError]:
    expected = tuple(model_cls.model_fields.keys())
    provided = tuple(bounds.keys())
    if set(expected) != set(provided):
        return Failure(
            BoundsFieldMismatch(
                expected=expected,
                provided=provided,
                reason="bounds must cover exactly the model's fields",
            )
        )
    for name, spec in bounds.items():
        checked = build_bound_spec(spec.lower, spec.upper)
        if isinstance(checked, Failure):
            return Failure(
                InvalidBounds(
                    field=name, lower=spec.lower, upper=spec.upper, reason=checked.error.reason
                )
            )
    return Success(DomainBounds(bounds=dict(bounds)))


class SobolConfig(BaseModel):
    """Parity: reference ``SobolConfig`` (sobol_sampler.py:64-93) — seed + resume skip."""

    model_config = ConfigDict(frozen=True, extra="forbid")
    seed: int
    skip: int = 0
    scramble: bool = True


class SobolSampler(Generic[TModel]):
    """Quasi-random sampler producing validated model instances or device arrays.

    Functional discipline: ``sample`` returns ``(points, advanced_sampler)``
    instead of mutating (the reference mutates its skip; here resume state is
    explicit so checkpoints are plain data).
    """

    def __init__(
        self,
        model_cls: Type[TModel],
        domain: DomainBounds,
        config: SobolConfig,
        directions_u32: np.ndarray,
        shift_u32: np.ndarray,
    ) -> None:
        self._model_cls = model_cls
        self._domain = domain
        self._config = config
        self._directions = directions_u32
        self._shift = shift_u32
        order = tuple(model_cls.model_fields.keys())
        self._field_order = order
        self._lower = np.array([domain.bounds[f].lower for f in order], dtype=np.float64)
        self._upper = np.array([domain.bounds[f].upper for f in order], dtype=np.float64)

    # -- construction -------------------------------------------------------

    @classmethod
    def create(
        cls,
        model_cls: Type[TModel],
        domain: Mapping[str, BoundSpec] | DomainBounds,
        config: SobolConfig,
    ) -> Result["SobolSampler[TModel]", SobolError]:
        if not isinstance(domain, DomainBounds):
            built = build_domain_bounds(model_cls, domain)
            if isinstance(built, Failure):
                return Failure(built.error)
            domain = built.value
        else:
            checked = build_domain_bounds(model_cls, domain.bounds)
            if isinstance(checked, Failure):
                return Failure(checked.error)
        dim = len(model_cls.model_fields)
        if dim > MAX_DIMENSION:
            return Failure(
                DimensionTooLarge(
                    dimension=dim, max_dimension=MAX_DIMENSION, reason="embed more Joe-Kuo data"
                )
            )
        if config.skip < 0:
            return Failure(InvalidSkip(skip=config.skip, reason="skip must be non-negative"))
        v = direction_numbers(dim)
        if config.scramble:
            rng = np.random.default_rng(config.seed)
            v, shift = _lms_scramble(v, rng)
        else:
            shift = np.zeros((dim,), dtype=np.uint32)
        return Success(cls(model_cls, domain, config, v, shift))

    # -- state --------------------------------------------------------------

    @property
    def skip(self) -> int:
        return self._config.skip

    @property
    def config(self) -> SobolConfig:
        return self._config

    @property
    def field_order(self) -> tuple[str, ...]:
        return self._field_order

    def with_skip(self, skip: int) -> "SobolSampler[TModel]":
        return SobolSampler(
            self._model_cls,
            self._domain,
            self._config.model_copy(update={"skip": skip}),
            self._directions,
            self._shift,
        )

    # -- device path (used inside jitted train steps) ------------------------

    def device_table(self) -> dict[str, jax.Array]:
        """Constants for in-jit sampling: directions, shift, bounds columns."""
        return {
            "directions": jnp.asarray(self._directions),
            "shift": jnp.asarray(self._shift),
            "lower": jnp.asarray(self._lower, dtype=jnp.float32),
            "upper": jnp.asarray(self._upper, dtype=jnp.float32),
        }

    def sample_array(
        self, count: int, dtype: jnp.dtype = jnp.float32, start: int | jax.Array | None = None
    ) -> jax.Array:
        """``[count, d]`` scaled points; pure in (table, start), jit-safe."""
        begin = self._config.skip if start is None else start
        unit = sobol_unit(
            jnp.asarray(self._directions), jnp.asarray(self._shift), begin, count, dtype
        )
        lower = jnp.asarray(self._lower, dtype=dtype)
        upper = jnp.asarray(self._upper, dtype=dtype)
        return scale_to_bounds(unit, lower, upper)

    # -- host path (validated model instances, float64 like the reference) ---

    def sample(self, count: int) -> tuple[tuple[TModel, ...], "SobolSampler[TModel]"]:
        pts = np.asarray(self.sample_array(count, dtype=jnp.float64 if jax.config.jax_enable_x64 else jnp.float32))
        rows = tuple(
            self._model_cls.model_validate(
                {f: float(pts[i, j]) for j, f in enumerate(self._field_order)}
            )
            for i in range(count)
        )
        return rows, self.with_skip(self._config.skip + count)
