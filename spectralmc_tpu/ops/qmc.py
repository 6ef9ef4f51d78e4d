"""Randomized quasi-Monte-Carlo path generation (Sobol + Brownian bridge).

Extension beyond the reference (no counterpart: the reference's only
low-discrepancy use is CONTRACT sampling, sobol_sampler.py — its path normals
are always pseudo-random cuRAND draws, async_normals.py:213-217). Here the
path increments themselves come from a scrambled Sobol net, which upgrades the
MC error rate from O(N^-1/2) toward O(N^-1) on smooth payoffs — a large
accuracy-per-FLOP win measured in ``tests/test_qmc.py`` and BENCH extras.

JAX-native design:

* **Brownian bridge as one matmul.** The bridge construction (Glasserman,
  "MC Methods in Financial Engineering" §3.1) is a LINEAR map from the
  quasi-random normal vector z (variance-ordered: z_0 drives the terminal
  value, later z's fill in ever-finer midpoints) to the path's Brownian
  increments. We precompute that ``[timesteps, timesteps]`` matrix ``M`` once
  on host (float64) and apply it on device as a single einsum — matmul work —
  instead of the scalar bisection loop a CPU/GPU implementation would run.
  Because unit-time-step Brownian increments are iid N(0,1), ``M`` is exactly
  orthogonal (``M Mᵀ = I``), which the tests assert to 1e-10: the map is a
  rotation of the normals, so plugging its output into the unchanged
  log-Euler/Euler scan bodies is distribution-exact.
* **Sobol point = path.** Point index = GLOBAL path index
  ``(row_offset + row) · cols + col`` — a pure function of global position,
  so a mesh shard owning rows ``[k, k+rows)`` generates bit-exactly the
  points a single-device run generates for those rows (the same
  shard-stability contract as the pseudo engine's
  ``(contract_key, global row, timestep)`` keying, gbm.py:488-499).
* **Randomization = LMS + per-draw digital shift.** The direction numbers are
  Owen linear-matrix-scrambled once per (dimension, mc_seed) on host
  (``ops/sobol.py::_lms_scramble``); each contract draw XORs in a fresh
  digital shift derived from the traced contract key (Matoušek's random
  linear scramble). Every draw is therefore an independent unbiased
  randomization of the same net — replicate draws give honest RQMC error
  bars, and resume stays a pure function of (seed, skip) exactly like the
  pseudo stream.
* **Padded QMC beyond 64 dimensions.** The embedded Joe-Kuo table covers 64
  dimensions; for ``timesteps > 64`` the coarse bridge levels (which carry
  almost all the variance — that is the point of the bridge ordering) take
  the Sobol dimensions and the fine tail levels take threefry normals keyed
  by (pad_key, global row, level) — Owen's padded/hybrid-QMC construction.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from spectralmc_tpu.ops._sobol_directions import MAX_DIMENSION
from spectralmc_tpu.ops.sobol import _lms_scramble, direction_numbers, sobol_uint32_t


# --------------------------------------------------------------------------
# Brownian-bridge increment map (host, float64, cached per timestep count)
# --------------------------------------------------------------------------


@lru_cache(maxsize=64)
def brownian_bridge_matrix(timesteps: int) -> np.ndarray:
    """``[timesteps, timesteps]`` float64 map: variance-ordered z → increments.

    Row ``t`` gives the coefficients of the Brownian increment over
    ``(t, t+1]`` (unit time steps) in terms of the bridge variates: z_0 sets
    the terminal value ``W_T = sqrt(T)·z_0``; z_k (breadth-first bisection
    order) sets the midpoint of the k-th largest remaining interval
    conditional on its endpoints. Exactly orthogonal — unit-step increments
    are iid N(0,1) — so applying it to iid (or LMS-scrambled Sobol) normals
    yields effective per-step normals with the identity covariance.
    """
    if timesteps < 1:
        raise ValueError(f"timesteps must be >= 1, got {timesteps}")
    t_total = timesteps
    # a[i, j] = coefficient of z_j in W_i (W on grid 0..T, W_0 = 0)
    a = np.zeros((t_total + 1, t_total), dtype=np.float64)
    a[t_total, 0] = np.sqrt(float(t_total))
    # breadth-first bisection: queue of (left, right) index intervals
    queue: list[tuple[int, int]] = [(0, t_total)]
    k = 1
    while queue:
        nxt: list[tuple[int, int]] = []
        for left, right in queue:
            if right - left < 2:
                continue
            mid = (left + right) // 2
            span = float(right - left)
            w_l = float(right - mid) / span
            w_r = float(mid - left) / span
            stddev = np.sqrt(float(mid - left) * float(right - mid) / span)
            a[mid] = w_l * a[left] + w_r * a[right]
            a[mid, k] += stddev
            k += 1
            nxt.append((left, mid))
            nxt.append((mid, right))
        queue = nxt
    return a[1:] - a[:-1]  # increments [T, T]


@lru_cache(maxsize=64)
def _qmc_tables(dim: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """LMS-scrambled direction numbers + host digital shift for (dim, seed)."""
    rng = np.random.default_rng(np.uint64(seed) ^ np.uint64(0x51B07C0FFEE))
    return _lms_scramble(direction_numbers(dim), rng)


def qmc_sobol_dims(timesteps: int, factors: int = 1) -> int:
    """How many flat (level, factor) dimensions the Sobol net covers.

    Multi-factor dynamics interleave factors within each bridge level
    (flat index = level·factors + factor) so the coarse levels of EVERY
    factor get the well-distributed dimensions; the remainder are padded.
    """
    return min(timesteps * factors, MAX_DIMENSION)


# --------------------------------------------------------------------------
# Device-side effective normals (jit-safe; static shapes, traced key/offset)
# --------------------------------------------------------------------------


def qmc_effective_normals_multi(
    contract_key: jax.Array,
    *,
    timesteps: int,
    factors: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    mc_seed: int,
    row_offset: jax.Array | int = 0,
) -> jax.Array:
    """``[timesteps, factors, rows, cols]`` unit-variance effective normals.

    The multi-factor generalization (Heston: 2 factors, baskets: one per
    asset): each factor gets its own Brownian bridge; the Sobol point's flat
    dimensions interleave factors within each bridge level
    (flat = level·factors + factor) so every factor's coarse levels land on
    well-distributed dimensions. Factor f's bridge variates are contiguous
    in level order after de-interleaving, and the same ``[T, T]`` orthogonal
    map applies to all factors in one einsum. Deterministic in
    (contract_key, mc_seed, global row range); shard-stable via global path
    index exactly like the single-factor path.
    """
    flat_total = timesteps * factors
    sdims = qmc_sobol_dims(timesteps, factors)
    directions_np, host_shift_np = _qmc_tables(sdims, mc_seed)
    directions = jnp.asarray(directions_np)
    host_shift = jnp.asarray(host_shift_np)

    shift_key, pad_key = jax.random.split(contract_key)
    draw_shift = jax.random.bits(shift_key, (sdims,), dtype=jnp.uint32)

    count = rows * cols
    start = jnp.asarray(row_offset, jnp.uint32) * jnp.uint32(cols)

    # Dimension-major generation: [sdims, count] keeps the huge point axis
    # minor for the uint32 -> uniform -> inverse-CDF elementwise pipeline,
    # and the bridge contraction below needs no [d, rows, cols] transpose.
    bits = sobol_uint32_t(directions, host_shift ^ draw_shift, start, count)
    z_sobol = _inv_cdf(bits).astype(dtype)  # [sdims, count]

    if sdims < flat_total:
        # fine (level, factor) tail: threefry pad keyed by
        # (pad_key, GLOBAL row, flat dimension)
        row_idx = jnp.asarray(row_offset, jnp.uint32) + jnp.arange(rows, dtype=jnp.uint32)
        row_keys = jax.vmap(lambda r: jax.random.fold_in(pad_key, r))(row_idx)

        def pad_level(j: jax.Array) -> jax.Array:
            return jax.vmap(
                lambda k: jax.random.normal(jax.random.fold_in(k, j), (cols,), dtype)
            )(row_keys)

        z_pad = jax.vmap(pad_level)(jnp.arange(sdims, flat_total))
        z_all = jnp.concatenate(
            [z_sobol, z_pad.reshape(flat_total - sdims, count)], axis=0
        )  # [T·F, count]
    else:
        z_all = z_sobol

    # de-interleave flat (level·F + factor) -> [levels, factors, count] and
    # contract the bridge as one plain matmul over the level axis — matmul work
    # with no input transpose in either orientation.
    z_lvl = z_all.reshape(timesteps, factors, count)
    bb = jnp.asarray(brownian_bridge_matrix(timesteps), dtype=dtype)
    out = jax.lax.dot_general(
        bb,
        z_lvl,
        (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )  # [T, factors, count]
    return out.reshape(timesteps, factors, rows, cols)


def _inv_cdf(bits: jax.Array) -> jax.Array:
    """uint32 Sobol fractions -> standard normals via the inverse CDF.

    Centered uniforms in (0, 1): top 24 bits + half-ulp. The inverse is
    ``sqrt(2)*erf_inv(2u-1)``: XLA's f32 ``erf_inv`` is a short polynomial,
    cheaper than ``ndtri``'s double-branch rational, and agrees with it to 7e-5 absolute in z — orders below f32 MC noise at
    any real path budget.

    TOP-BUCKET GUARD (round-4 bug find, caught by a fused-kernel
    bit-identity probe at the 134M-draw bench shape): for the maximal bucket
    ``top24 = 2^24-1`` the sum ``top24 + 0.5`` needs 25 mantissa bits and
    rounds UP to ``2^24`` in f32, making ``u`` exactly 1 and the inverse
    ``inf`` — one poisoned draw per ~16.8M, i.e. near-certain at production
    path counts. That bucket alone is remapped to its INTENDED argument
    ``x = 1 - 2^-24`` (z ≈ +5.42); every other bucket's f32 value is
    reproduced bit for bit, so recorded SOBOL_BB streams are unchanged
    except where they held ``inf``. The symmetric bottom bucket is safe
    (``0 + 0.5`` is exact). Gated by ``tests/test_qmc.py::test_inv_cdf_*``.
    """
    top24 = bits >> jnp.uint32(8)
    u = (top24.astype(jnp.float32) + jnp.float32(0.5)) * jnp.float32(2.0**-24)
    x = jnp.float32(2.0) * u - jnp.float32(1.0)
    x = jnp.where(
        top24 == jnp.uint32(0xFFFFFF), jnp.float32(1.0 - 2.0**-24), x
    )
    root2 = jnp.float32(1.4142135623730951)
    return root2 * jax.lax.erf_inv(x)


def qmc_terminal_normals(
    contract_key: jax.Array,
    *,
    timesteps: int,
    factors: int = 1,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    mc_seed: int,
    row_offset: jax.Array | int = 0,
) -> jax.Array:
    """``[factors, rows, cols]`` TERMINAL bridge variates — dimension 0 only.

    The bridge map is exactly orthogonal with ``Σ_t increments = √T·z_0``
    (its construction: z_0 IS the terminal value, ``brownian_bridge_matrix``).
    For payoffs that consume only the terminal state of an exact-Gaussian
    walk (flat log-Euler GBM), the other ``timesteps−1`` Sobol dimensions,
    the ``ndtri`` over them, the bridge matmul and the timestep scan are all
    dead work — the same one-draw-per-observable principle as the cliquet
    period kernel (ops/gbm_pallas.py ``gbm_cliquet``). Returns the SAME
    z_0 values ``qmc_effective_normals_multi`` would produce for dimension
    0 of each factor: the scramble/shift stream is derived identically over
    the FULL dimension count and then sliced, so shortcut and full-path
    engines price with the same terminal variates.
    """
    flat_total = timesteps * factors
    sdims = qmc_sobol_dims(timesteps, factors)
    directions_np, host_shift_np = _qmc_tables(sdims, mc_seed)
    # factor f's terminal variate is flat dimension f (level 0, interleaved)
    directions = jnp.asarray(directions_np[:factors])
    host_shift = jnp.asarray(host_shift_np[:factors])

    shift_key, _pad_key = jax.random.split(contract_key)
    draw_shift = jax.random.bits(shift_key, (sdims,), dtype=jnp.uint32)[:factors]

    count = rows * cols
    start = jnp.asarray(row_offset, jnp.uint32) * jnp.uint32(cols)
    bits = sobol_uint32_t(directions, host_shift ^ draw_shift, start, count)
    z0 = _inv_cdf(bits).astype(dtype)  # [factors, count]
    del flat_total
    return z0.reshape(factors, rows, cols)


def qmc_effective_normals(
    contract_key: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    mc_seed: int,
    row_offset: jax.Array | int = 0,
) -> jax.Array:
    """``[timesteps, rows, cols]`` single-factor effective normals.

    Drop-in replacement for the pseudo engine's per-step
    ``normal(fold_in(row_key, t), (cols,))`` draws: same shape, same marginal
    distribution, same shard-stability in ``row_offset`` — but the joint
    sample over timesteps is a Brownian-bridge-ordered scrambled Sobol point
    per path. The factors=1 slice of the multi-factor generator (bit-exact:
    the flat interleave is the identity at one factor).
    """
    return qmc_effective_normals_multi(
        contract_key,
        timesteps=timesteps,
        factors=1,
        rows=rows,
        cols=cols,
        dtype=dtype,
        mc_seed=mc_seed,
        row_offset=row_offset,
    )[:, 0]


__all__ = [
    "brownian_bridge_matrix",
    "qmc_effective_normals",
    "qmc_effective_normals_multi",
    "qmc_sobol_dims",
    "qmc_terminal_normals",
]
