"""Fused Monte-Carlo Pallas kernels (Triton route): in-kernel RNG + path stepping.

The reference's hot kernel ran one CUDA thread per path over a precomputed
cuRAND normals matrix (``[timesteps, paths]`` in device memory). These
kernels fuse the normals into the path loop (SURVEY §2.9, N1+N2):

* Each program owns a ``(block_rows, block_cols)`` tile of paths; the path
  state stays in registers for the whole time loop and only terminal (or
  monitor-date) values are written to device memory.
* Normals come from a counter-based generator evaluated in the kernel:
  threefry-2x32 (``jax.random``'s own block function) keyed by the
  contract's key words and addressed by (global row, global column, draw
  index), then Box–Muller. The stream is therefore independent of the block
  shape and of mesh sharding (``row_offset``), and a plain-``jnp`` replay of
  the same generator (``threefry2x32``) is the reference the tests use.
* The kernels are lowered through Pallas' Triton route
  (``backend="triton"``); ``interpret=True`` runs them on the CPU.

Determinism contract: the XLA path (``gbm.simulate_terminal_rows``) defines
the *canonical* bit stream; these kernels have their own (a different draw
layout and Box–Muller instead of the inverse CDF). ``SimulationParams
.implementation`` records which engine produced a checkpoint, and
``PALLAS_STREAM_VERSIONS`` versions each kernel's stream, so resume stays
bit-exact per engine. Cross-engine agreement is statistical.

float32 only; a request the kernels cannot run raises (``resolve_implementation``
in ``ops/gbm.py`` is the one router between the engines).
"""

from __future__ import annotations

import functools
import math
from typing import Callable

from spectralmc_tpu.core.aliases import PyTree

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from spectralmc_tpu.ops.gbm import (
    BARRIER_PAYOFFS,
    LOOKBACK_MAX_PAYOFFS,
    LOOKBACK_PAYOFFS,
    PathScheme,
    PayoffKind,
    lookback_underlier,
)

# Tile of paths per program: powers of two (Triton's rule), small enough
# that the state and the generator's temporaries stay in registers, and
# numerous enough at production shapes to fill every SM.
BLOCK_ROWS = 8
BLOCK_COLS = 128
NUM_WARPS = 4
# Contract scalars are passed as one padded float32 vector (Heston has 10).
_PARAM_SLOTS = 16
# Monitor-date bound of the American kernels (production grids are 8-64).
_MONITOR_MAX_DATES = 128

_TWO_PI = 2.0 * math.pi
# Box-Muller: uniforms from the top 24 bits (exact float32 mantissa); the
# 2^-25 offset keeps u1 > 0 so log(u1) is finite.
_INV_2_24 = float(2.0**-24)
_HALF_ULP = float(2.0**-25)


# Each kernel's bit stream is versioned PER FAMILY: any change to the draw
# layout or to the transcendental evaluation order changes the stream, and
# a mid-stream checkpoint must not silently continue on another one (the
# same contract as engine recording). Every entry was bumped when the
# kernels moved to the in-kernel threefry stream (interleaved antithetic
# pairs, floor-based turn folding), so a checkpoint written by the earlier
# kernels fails with EngineMismatch
# instead of resuming on a different stream. Keys: the European kernel per
# dynamics, ``gbm_term`` (curved term structures, per-step coefficient
# table), ``gbm_cliquet`` (one Gaussian per reset period) and the American
# monitor-row kernels ``american_{family}``.
PALLAS_STREAM_VERSIONS: dict[str, int] = {
    "gbm": 3,
    "gbm_term": 2,
    "gbm_cliquet": 2,
    "heston": 4,
    "basket_gbm": 2,
    "merton_jump": 2,
    "american_gbm": 2,
    "american_heston": 2,
    "american_merton_jump": 2,
    "american_basket_gbm": 2,
}


def pallas_stream_version(
    model: "object", payoff: "object | None" = None, *, term: bool = False
) -> int:
    """Current stream version for a (ModelKind[, PayoffKind]) pair — by value,
    avoids an import. The AMERICAN payoff kinds run a DIFFERENT forward
    kernel (monitor rows, not terminal values), so their stream is versioned
    under its own ``american_{family}`` key: a rebuild of the European
    terminal kernel must not invalidate American checkpoints or vice versa.
    ``term=True`` (a genuinely curved ``TermStructure`` on GBM) selects the
    term kernel's own ``gbm_term`` key for the same reason.
    """
    family = getattr(model, "value", str(model))
    payoff_value = str(getattr(payoff, "value", payoff)) if payoff is not None else ""
    if payoff_value.startswith("american"):
        return PALLAS_STREAM_VERSIONS[f"american_{family}"]
    if payoff_value == "cliquet" and family == "gbm" and not term:
        # only flat GBM has a per-period cliquet kernel; a curved-term
        # cliquet is not that program, so fall through to the term key
        return PALLAS_STREAM_VERSIONS["gbm_cliquet"]
    if term and family == "gbm":
        return PALLAS_STREAM_VERSIONS["gbm_term"]
    return PALLAS_STREAM_VERSIONS[family]


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _block(rows: int, cols: int) -> tuple[int, int]:
    return min(BLOCK_ROWS, rows), min(BLOCK_COLS, cols)


def _shape_ok(*, dtype: jnp.dtype, rows: int, cols: int) -> bool:
    """The Triton kernels' own shape rules: float32 and power-of-two blocks
    that tile the ``[rows, cols]`` grid exactly."""
    br, bc = _block(rows, cols)
    return (
        jnp.dtype(dtype) == jnp.dtype(jnp.float32)
        and _pow2(br)
        and _pow2(bc)
        and rows % br == 0
        and cols % bc == 0
    )


def pallas_supported(*, dtype: jnp.dtype, rows: int, cols: int) -> bool:
    """Whether the fused kernels can honor this request on this backend.

    Single source of truth for ``gbm.resolve_implementation`` — the engine
    recorded in a checkpoint must be the one that actually ran, so this
    predicate and the wrappers' refusals may never diverge.
    """
    return _shape_ok(dtype=dtype, rows=rows, cols=cols) and jax.default_backend() == "gpu"


def _check_runnable(what: str, ok: bool, *, interpret: bool) -> None:
    """Refuse instead of silently switching engines: a wrapper called at a
    shape or on a backend its kernel cannot run raises."""
    if ok and (interpret or jax.default_backend() == "gpu"):
        return
    raise ValueError(
        f"{what}: the fused Pallas kernel cannot run this request "
        f"(backend={jax.default_backend()!r}, interpret={interpret}); it needs "
        f"float32, power-of-two row/col blocks that tile the grid, and a GPU "
        f"or interpret=True — route through gbm.resolve_implementation"
    )


# --------------------------------------------------------------------------
# The in-kernel generator
# --------------------------------------------------------------------------

_THREEFRY_PARITY = 0x1BD11BDA
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(
    k0: jax.Array, k1: jax.Array, x0: jax.Array, x1: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Threefry-2x32, 20 rounds, on uint32 arrays — the block function of
    ``jax.random``'s default generator, written in plain ``jnp`` so the same
    code lowers inside a kernel and runs as the host reference."""
    ks = (k0, k1, k0 ^ k1 ^ jnp.uint32(_THREEFRY_PARITY))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << jnp.uint32(r)) | (x1 >> jnp.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0, x1


def _unit(bits: jax.Array) -> jax.Array:
    """Uniform in [0, 1) from the top 24 bits (exact float32 mantissa)."""
    return (bits >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) * jnp.float32(
        _INV_2_24
    )


def stream_bits(
    key_words: tuple[jax.Array, jax.Array],
    rows: jax.Array,
    cols: jax.Array,
    draw: jax.Array | int,
    *,
    total_cols: int,
    antithetic: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """The two 32-bit words of draw ``draw`` for the lanes at global
    (``rows``, ``cols``): threefry over counter (row, draw·total_cols + col).
    Antithetic partners are the global row pairs (2k, 2k+1), which share the
    draws of row k. Plain ``jnp``: the kernels and the tests both call it."""
    row = rows >> jnp.uint32(1) if antithetic else rows
    x1 = cols + jnp.asarray(draw, jnp.uint32) * jnp.uint32(total_cols)
    if row.shape != x1.shape:
        row, x1 = jnp.broadcast_arrays(row, x1)
    return threefry2x32(key_words[0], key_words[1], row, x1)


class _Stream:
    """One program's view of the counter-based stream.

    ``ctr`` is the per-lane draw index; it is threaded through every loop by
    ``_fori`` so that a draw is addressed by (key, global row, global col,
    draw index) no matter how the time loop is written. Distinct draws stay
    distinct while ``draws × total_cols < 2^32``.
    """

    def __init__(
        self, seeds_ref, *, block: tuple[int, int], cols: int, antithetic: bool
    ) -> None:
        br, bc = block
        self.key = (seeds_ref[0], seeds_ref[1])
        row0 = (pl.program_id(0) * br).astype(jnp.uint32) + seeds_ref[2]
        col0 = (pl.program_id(1) * bc).astype(jnp.uint32)
        self.rows = row0 + jax.lax.broadcasted_iota(jnp.int32, block, 0).astype(jnp.uint32)
        self.cols = col0 + jax.lax.broadcasted_iota(jnp.int32, block, 1).astype(jnp.uint32)
        self.total_cols = cols
        self.antithetic = antithetic
        self.sign = (
            jnp.float32(1.0)
            - jnp.float32(2.0) * (self.rows & jnp.uint32(1)).astype(jnp.int32).astype(jnp.float32)
            if antithetic
            else None
        )
        self.ctr = jnp.uint32(0)

    def bits(self) -> tuple[jax.Array, jax.Array]:
        out = stream_bits(
            self.key, self.rows, self.cols, self.ctr,
            total_cols=self.total_cols, antithetic=self.antithetic,
        )
        self.ctr = self.ctr + jnp.uint32(1)
        return out

    def pair(self) -> tuple[jax.Array, jax.Array]:
        """(u1, u2) for one Box–Muller draw: u1 in (0, 1], u2 in [0, 1)."""
        b0, b1 = self.bits()
        return _unit(b0) + jnp.float32(_HALF_ULP), _unit(b1)

    def uniform(self) -> jax.Array:
        return _unit(self.bits()[0])

    def mirror(self, z: jax.Array) -> jax.Array:
        """Antithetic sign: odd global rows take their partner's draw negated."""
        return z if self.sign is None else z * self.sign


def _fori(
    rng: _Stream, n: int, body: "Callable[[jax.Array, PyTree], PyTree]", init: PyTree
) -> PyTree:
    """``fori_loop`` over ``body(t, carry)`` that threads the stream's draw
    counter through the carry."""
    if n <= 0:
        return init

    def step(t: jax.Array, state: tuple[jax.Array, PyTree]) -> tuple[jax.Array, PyTree]:
        rng.ctr, carry = state
        carry = body(t, carry)
        return rng.ctr, carry

    rng.ctr, out = jax.lax.fori_loop(0, n, step, (rng.ctr, init))
    return out


def _sin_turns(t: jax.Array) -> jax.Array:
    """sin(2*pi*t). libdevice's ``sin`` beat the folded degree-9 polynomial
    in the flat GBM kernel on the H100 (PERF.md), so the single sine is the
    library's."""
    return jnp.sin(jnp.float32(_TWO_PI) * t)


def _sincos_turns(t: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(sin, cos)(2*pi*t) sharing ONE half-turn fold and the x^2 powers:
    degree-9 odd / degree-10 even Taylor, max error < 4e-6 on the fold (below
    the 24-bit uniform quantization). Faster than libdevice's ``sin`` and
    ``cos`` pair in the Heston kernel on the H100 (PERF.md)."""
    qf = jnp.floor(jnp.float32(2.0) * t + jnp.float32(0.5))
    x = jnp.float32(_TWO_PI) * (t - jnp.float32(0.5) * qf)
    sign = jnp.where(qf.astype(jnp.int32) & 1, jnp.float32(-1.0), jnp.float32(1.0))
    y = x * x
    ps = jnp.float32(2.7557319e-6)
    ps = ps * y + jnp.float32(-1.9841270e-4)
    ps = ps * y + jnp.float32(8.3333333e-3)
    ps = ps * y + jnp.float32(-1.6666667e-1)
    ps = ps * y + jnp.float32(1.0)
    pc = jnp.float32(-2.7557319e-7)
    pc = pc * y + jnp.float32(2.4801587e-5)
    pc = pc * y + jnp.float32(-1.3888889e-3)
    pc = pc * y + jnp.float32(4.1666667e-2)
    pc = pc * y + jnp.float32(-5.0e-1)
    pc = pc * y + jnp.float32(1.0)
    return sign * x * ps, sign * pc


def _bm_radius(u1: jax.Array) -> jax.Array:
    """Box-Muller radius sqrt(-2 ln u1)."""
    return jnp.sqrt(jnp.float32(-2.0) * jnp.log(u1))


def _launch(
    kernel: Callable[..., None],
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    rows: int,
    cols: int,
    row_offset: jax.Array | int,
    interpret: bool,
    monitors: int | None = None,
    n_out: int = 1,
    tables: tuple[jax.Array, ...] = (),
) -> jax.Array | tuple[jax.Array, ...]:
    """One ``pallas_call`` on the Triton route over a ``(rows/br, cols/bc)``
    grid. Inputs are whole-array blocks each program loads itself: the
    padded contract scalars, the seed words (key words, row offset) and any
    coefficient tables. Outputs are ``[rows, cols]`` tiles, or
    ``[monitors, rows, cols]`` when the kernel emits monitor dates."""
    br, bc = _block(rows, cols)
    params = jnp.pad(
        contract.astype(jnp.float32).reshape(-1), (0, _PARAM_SLOTS - contract.shape[-1])
    )
    key_words = jax.random.key_data(contract_key).astype(jnp.uint32).reshape(2)
    seeds = jnp.concatenate(
        [key_words, jnp.asarray(row_offset, jnp.uint32).reshape(1), jnp.zeros(1, jnp.uint32)]
    )
    inputs = (params, seeds, *tables)

    def whole(a: jax.Array) -> pl.BlockSpec:
        return pl.BlockSpec(a.shape, lambda i, j: (0,) * a.ndim)

    if monitors is None:
        shape = jax.ShapeDtypeStruct((rows, cols), jnp.float32)
        spec = pl.BlockSpec((br, bc), lambda i, j: (i, j))
    else:
        shape = jax.ShapeDtypeStruct((monitors, rows, cols), jnp.float32)
        spec = pl.BlockSpec((monitors, br, bc), lambda i, j: (0, i, j))
    return pl.pallas_call(
        functools.partial(kernel, block=(br, bc), cols=cols),
        out_shape=shape if n_out == 1 else (shape,) * n_out,
        grid=(rows // br, cols // bc),
        in_specs=[whole(a) for a in inputs],
        out_specs=spec if n_out == 1 else (spec,) * n_out,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name=getattr(kernel, "func", kernel).__name__.strip("_"),
    )(*inputs)


def _term_coeff_tables(
    contract: jax.Array, term_shapes: tuple[tuple[float, ...], ...], timesteps: int
) -> tuple[jax.Array, jax.Array]:
    """(step [T,2], pair [max(T//2,1),2]) float32 coefficient tables.

    step[t] = (log-drift_t·dt, vol_t·√dt). pair[p] packs the phase-shift
    constants that keep the Box–Muller pair-step alive under per-step vols:

        v_a·r·cos θ + v_b·r·sin θ = r·R·sin(θ + φ),
        R = √(v_a² + v_b²)·√dt,  φ = atan2(v_a, v_b) / 2π  (turns)

    — the flat kernel's ``√2·sin(θ + 1/8)`` is the v_a = v_b special case.
    """
    vs, rs, qs = term_shapes
    dtype = jnp.float32
    _, _, maturity, rate, div_yield, vol = (contract[i].astype(dtype) for i in range(6))
    dt = maturity / jnp.asarray(timesteps, dtype)
    sqrt_dt = jnp.sqrt(dt)
    vsa, rsa, qsa = (jnp.asarray(s, dtype) for s in (vs, rs, qs))
    vol_t = vol * vsa
    drift = (rate * rsa - div_yield * qsa - 0.5 * vol_t * vol_t) * dt
    vol_sdt = vol_t * sqrt_dt
    step = jnp.stack([drift, vol_sdt], axis=1)  # [T, 2]
    n_pairs = max(timesteps // 2, 1)
    va = vol_sdt[0 : 2 * n_pairs : 2]
    vb = vol_sdt[1 : 2 * n_pairs : 2]
    radius = jnp.sqrt(va * va + vb * vb)
    phi_turns = jnp.arctan2(va, vb) * jnp.float32(1.0 / _TWO_PI)
    pair = jnp.stack([radius, phi_turns], axis=1)  # [T//2, 2]
    return step, pair


def _term_table(
    contract: jax.Array, term_shapes: tuple[tuple[float, ...], ...], timesteps: int
) -> jax.Array:
    """The term kernel's one table: row t = (drift_t, vol_sdt_t, R_p, φ_p)
    with the pair columns filled for p < T//2."""
    step, pair = _term_coeff_tables(contract, term_shapes, timesteps)
    pair = jnp.pad(pair, ((0, timesteps - pair.shape[0]), (0, 0)))
    return jnp.concatenate([step, pair], axis=1)


def _extreme_kind(payoff: PayoffKind) -> tuple[bool, bool, Callable[..., jax.Array]]:
    """(lookback, up, extreme_fn) of a barrier or lookback payoff."""
    up = payoff == PayoffKind.BARRIER_UP_OUT or payoff in LOOKBACK_MAX_PAYOFFS
    return payoff in LOOKBACK_PAYOFFS, up, jnp.maximum if up else jnp.minimum


def _gbm_term_block_kernel(
    params_ref, seeds_ref, tab_ref, out_ref, *,
    block: tuple[int, int], cols: int, timesteps: int, payoff: PayoffKind,
    barrier_rel: float | None = None, antithetic: bool = False,
) -> None:
    """Log-Euler GBM under piecewise-constant curves (stream ``gbm_term``):
    the flat kernel's draw order per payoff branch, with the per-step
    coefficients read from the table (``_term_table``)."""
    rng = _Stream(seeds_ref, block=block, cols=cols, antithetic=antithetic)
    spot, strike, maturity = params_ref[0], params_ref[1], params_ref[2]

    def step_single(t: jax.Array, logx: jax.Array) -> jax.Array:
        u1, u2 = rng.pair()
        z = rng.mirror(_bm_radius(u1) * _sin_turns(u2 + jnp.float32(0.25)))
        return logx + tab_ref[t, 0] + tab_ref[t, 1] * z

    log0 = jnp.full(block, 0.0, jnp.float32) + jnp.log(spot)
    if payoff == PayoffKind.TERMINAL:
        # phase-shifted pair step: both Box–Muller outputs advance two
        # steps with ONE sine even though the two vols differ
        def step_pair(p: jax.Array, logx: jax.Array) -> jax.Array:
            u1, u2 = rng.pair()
            z_mix = rng.mirror(_bm_radius(u1) * tab_ref[p, 2] * _sin_turns(u2 + tab_ref[p, 3]))
            t = 2 * p
            return logx + (tab_ref[t, 0] + tab_ref[t + 1, 0]) + z_mix

        logx = _fori(rng, timesteps // 2, step_pair, log0)
        if timesteps % 2:
            logx = step_single(timesteps - 1, logx)
        out_ref[...] = jnp.exp(logx)
    elif payoff in BARRIER_PAYOFFS or payoff in LOOKBACK_PAYOFFS:
        lookback, up, extreme_fn = _extreme_kind(payoff)

        def step_barrier(t: jax.Array, carry: tuple[jax.Array, jax.Array]) -> tuple[jax.Array, jax.Array]:
            logx, ext = carry
            logx = step_single(t, logx)
            return (logx, extreme_fn(ext, logx))

        logx, ext = _fori(rng, timesteps, step_barrier, (log0, log0))
        if lookback:
            out_ref[...] = lookback_underlier(payoff, strike, jnp.exp(ext), jnp.exp(logx))
        else:
            level = jnp.log(spot * jnp.float32(barrier_rel))
            knocked = ext >= level if up else ext <= level
            out_ref[...] = jnp.where(knocked, strike, jnp.exp(logx))
    elif payoff == PayoffKind.VARIANCE_SWAP:
        # per-step vols break the z1+z2 trick, but ONE _sincos_turns fold
        # still yields both increments of a pair (independent normals)
        def step_pair_var(p: jax.Array, acc: jax.Array) -> jax.Array:
            u1, u2 = rng.pair()
            radius = _bm_radius(u1)
            sin_t, cos_t = _sincos_turns(u2)
            t = 2 * p
            inc_a = tab_ref[t, 0] + tab_ref[t, 1] * rng.mirror(radius * cos_t)
            inc_b = tab_ref[t + 1, 0] + tab_ref[t + 1, 1] * rng.mirror(radius * sin_t)
            return acc + inc_a * inc_a + inc_b * inc_b

        acc = _fori(rng, timesteps // 2, step_pair_var, jnp.zeros(block, jnp.float32))
        if timesteps % 2:
            inc = step_single(timesteps - 1, jnp.zeros(block, jnp.float32))
            acc = acc + inc * inc
        out_ref[...] = acc / maturity
    else:
        geometric = payoff == PayoffKind.ASIAN_GEOMETRIC

        def step_acc(t: jax.Array, carry: tuple[jax.Array, jax.Array]) -> tuple[jax.Array, jax.Array]:
            logx, acc = carry
            logx = step_single(t, logx)
            return (logx, acc + (logx if geometric else jnp.exp(logx)))

        _, acc = _fori(rng, timesteps, step_acc, (log0, jnp.zeros(block, jnp.float32)))
        inv_n = jnp.float32(1.0 / timesteps)
        out_ref[...] = jnp.exp(acc * inv_n) if geometric else acc * inv_n


def _gbm_block_kernel(
    params_ref, seeds_ref, out_ref, *,
    block: tuple[int, int], cols: int, timesteps: int, scheme: PathScheme,
    payoff: PayoffKind, barrier_rel: float | None = None, antithetic: bool = False,
) -> None:
    """Flat GBM (stream ``gbm``) under either path scheme, every non-American
    payoff epilogue."""
    rng = _Stream(seeds_ref, block=block, cols=cols, antithetic=antithetic)
    spot, strike, maturity, rate, div_yield, vol = (params_ref[k] for k in range(6))
    dt = maturity / jnp.float32(timesteps)
    vol_sdt = vol * jnp.sqrt(dt)

    def normals() -> jax.Array:
        # one Box-Muller output: z = r*cos(2*pi*u2) = r*sin(2*pi*(u2 + 1/4))
        u1, u2 = rng.pair()
        return rng.mirror(_bm_radius(u1) * _sin_turns(u2 + jnp.float32(0.25)))

    inv_n = jnp.float32(1.0 / timesteps)
    zeros = jnp.zeros(block, jnp.float32)
    if scheme == PathScheme.LOG_EULER:
        drift = (rate - div_yield - jnp.float32(0.5) * vol * vol) * dt

        def step_single(logx: jax.Array) -> jax.Array:
            return logx + drift + vol_sdt * normals()

        log0 = zeros + jnp.log(spot)
        if payoff == PayoffKind.TERMINAL:
            # log-Euler increments are additive, so both Box–Muller outputs
            # advance two timesteps per draw; their sum needs only ONE sine:
            # z1 + z2 = r*(cos+sin)(theta) = r*sqrt(2)*sin(theta + pi/4)
            def step_pair(_t: jax.Array, logx: jax.Array) -> jax.Array:
                u1, u2 = rng.pair()
                z_sum = rng.mirror(
                    _bm_radius(u1) * jnp.float32(math.sqrt(2.0)) * _sin_turns(u2 + jnp.float32(0.125))
                )
                return logx + jnp.float32(2.0) * drift + vol_sdt * z_sum

            logx = _fori(rng, timesteps // 2, step_pair, log0)
            if timesteps % 2:
                logx = step_single(logx)
            out_ref[...] = jnp.exp(logx)
        elif payoff in BARRIER_PAYOFFS or payoff in LOOKBACK_PAYOFFS:
            lookback, up, extreme_fn = _extreme_kind(payoff)

            def step_barrier(_t: jax.Array, carry: tuple[jax.Array, jax.Array]) -> tuple[jax.Array, jax.Array]:
                logx, ext = carry
                logx = step_single(logx)
                return (logx, extreme_fn(ext, logx))

            logx, ext = _fori(rng, timesteps, step_barrier, (log0, log0))
            if lookback:
                out_ref[...] = lookback_underlier(payoff, strike, jnp.exp(ext), jnp.exp(logx))
            else:
                level = jnp.log(spot * jnp.float32(barrier_rel))
                knocked = ext >= level if up else ext <= level
                out_ref[...] = jnp.where(knocked, strike, jnp.exp(logx))
        elif payoff == PayoffKind.VARIANCE_SWAP:
            # RV is state-free under log-Euler, and the pair-step shortcut
            # survives squaring: with a = drift, b = vol·√dt,
            #   (a+b·z1)² + (a+b·z2)² = 2a² + b²·r² + 2ab·(z1+z2),
            #   z1+z2 = r·√2·sin(θ+π/4),  r² = −2·ln u1
            # — ONE sine and ZERO exp per TWO timesteps
            base_c = jnp.float32(2.0) * drift * drift
            b_sq = vol_sdt * vol_sdt
            cross_c = jnp.float32(2.0 * math.sqrt(2.0)) * drift * vol_sdt

            def step_pair_var(_t: jax.Array, acc: jax.Array) -> jax.Array:
                u1, u2 = rng.pair()
                x = jnp.float32(-2.0) * jnp.log(u1)  # r²
                s = jnp.sqrt(x) * _sin_turns(u2 + jnp.float32(0.125))
                # z → −z flips only the cross term
                return acc + (base_c + b_sq * x) + rng.mirror(cross_c * s)

            acc = _fori(rng, timesteps // 2, step_pair_var, zeros)
            if timesteps % 2:
                inc = drift + vol_sdt * normals()
                acc = acc + inc * inc
            out_ref[...] = acc / maturity
        else:
            # path-dependent average: every intermediate state feeds the
            # running sum, so the pair-step shortcut does not apply
            geometric = payoff == PayoffKind.ASIAN_GEOMETRIC

            def step_acc(_t: jax.Array, carry: tuple[jax.Array, jax.Array]) -> tuple[jax.Array, jax.Array]:
                logx, acc = carry
                logx = step_single(logx)
                return (logx, acc + (logx if geometric else jnp.exp(logx)))

            _, acc = _fori(rng, timesteps, step_acc, (log0, zeros))
            out_ref[...] = jnp.exp(acc * inv_n) if geometric else acc * inv_n
    else:
        growth = jnp.float32(1.0) + (rate - div_yield) * dt

        def step_euler(x: jax.Array) -> jax.Array:
            return jnp.abs(x * (growth + vol_sdt * normals()))

        x0 = zeros + spot
        if payoff == PayoffKind.TERMINAL:
            out_ref[...] = _fori(rng, timesteps, lambda _t, x: step_euler(x), x0)
        elif payoff in BARRIER_PAYOFFS or payoff in LOOKBACK_PAYOFFS:
            lookback, up, extreme_fn = _extreme_kind(payoff)

            def step_euler_barrier(_t: jax.Array, carry: tuple[jax.Array, jax.Array]) -> tuple[jax.Array, jax.Array]:
                x, ext = carry
                x = step_euler(x)
                return (x, extreme_fn(ext, x))

            x, ext = _fori(rng, timesteps, step_euler_barrier, (x0, x0))
            if lookback:
                out_ref[...] = lookback_underlier(payoff, strike, ext, x)
            else:
                level = spot * jnp.float32(barrier_rel)
                knocked = ext >= level if up else ext <= level
                out_ref[...] = jnp.where(knocked, strike, x)
        elif payoff == PayoffKind.VARIANCE_SWAP:
            # the ratio x'/x = |growth + vol·√dt·z| is state-free
            def step_euler_var(_t: jax.Array, acc: jax.Array) -> jax.Array:
                inc = jnp.log(jnp.abs(growth + vol_sdt * normals()))
                return acc + inc * inc

            out_ref[...] = _fori(rng, timesteps, step_euler_var, zeros) / maturity
        else:
            geometric = payoff == PayoffKind.ASIAN_GEOMETRIC

            def step_euler_acc(_t: jax.Array, carry: tuple[jax.Array, jax.Array]) -> tuple[jax.Array, jax.Array]:
                x, acc = carry
                x = step_euler(x)
                return (x, acc + (jnp.log(x) if geometric else x))

            _, acc = _fori(rng, timesteps, step_euler_acc, (x0, zeros))
            out_ref[...] = jnp.exp(acc * inv_n) if geometric else acc * inv_n


@functools.partial(
    jax.jit,
    static_argnames=(
        "timesteps", "rows", "cols", "scheme", "payoff", "barrier_rel",
        "antithetic", "interpret",
    ),
)
def _simulate_rows_pallas_f32(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    scheme: PathScheme,
    payoff: PayoffKind = PayoffKind.TERMINAL,
    barrier_rel: float | None = None,
    antithetic: bool = False,
    row_offset: jax.Array | int = 0,
    interpret: bool = False,
) -> jax.Array:
    kernel = functools.partial(
        _gbm_block_kernel, timesteps=timesteps, scheme=scheme, payoff=payoff,
        barrier_rel=barrier_rel, antithetic=antithetic,
    )
    return _launch(
        kernel, contract_key, contract,
        rows=rows, cols=cols, row_offset=row_offset, interpret=interpret,
    )


def _gbm_cliquet_block_kernel(
    params_ref, seeds_ref, out_ref, *,
    block: tuple[int, int], cols: int, timesteps: int, reset_every: int,
    floor: float, cap: float, antithetic: bool,
) -> None:
    """Cliquet accumulator u = Σ_j clip(exp(L_j) − 1, floor, cap), sampling
    each period's log-return L_j DIRECTLY: under flat log-Euler GBM,
    L_j = k·drift + vol·√dt·Σ_{t∈period} z_t is an exact Gaussian sum, so one
    N(k·drift, k·vol²·dt) draw per period is the identical distribution with
    ``reset_every``× fewer draws. Two periods share one Box–Muller draw via
    ``_sincos_turns``. Stream key ``gbm_cliquet``."""
    rng = _Stream(seeds_ref, block=block, cols=cols, antithetic=antithetic)
    maturity, rate, div_yield, vol = (params_ref[k] for k in range(2, 6))
    dt = maturity / jnp.float32(timesteps)
    n_periods = timesteps // reset_every
    period_drift = (rate - div_yield - jnp.float32(0.5) * vol * vol) * dt * jnp.float32(reset_every)
    period_vol = vol * jnp.sqrt(dt * jnp.float32(reset_every))

    def _clipped(z: jax.Array) -> jax.Array:
        ret = jnp.exp(period_drift + period_vol * z) - jnp.float32(1.0)
        return jnp.clip(ret, jnp.float32(floor), jnp.float32(cap))

    def period_pair(_t: jax.Array, acc: jax.Array) -> jax.Array:
        u1, u2 = rng.pair()
        r = _bm_radius(u1)
        s, c = _sincos_turns(u2)
        return acc + _clipped(rng.mirror(r * c)) + _clipped(rng.mirror(r * s))

    acc = _fori(rng, n_periods // 2, period_pair, jnp.zeros(block, jnp.float32))
    if n_periods % 2:
        u1, u2 = rng.pair()
        acc = acc + _clipped(rng.mirror(_bm_radius(u1) * _sin_turns(u2 + jnp.float32(0.25))))
    out_ref[...] = acc


@functools.partial(
    jax.jit,
    static_argnames=(
        "timesteps", "rows", "cols", "reset_every", "floor", "cap",
        "antithetic", "interpret",
    ),
)
def _simulate_cliquet_rows_pallas_f32(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    reset_every: int,
    floor: float,
    cap: float,
    antithetic: bool = False,
    row_offset: jax.Array | int = 0,
    interpret: bool = False,
) -> jax.Array:
    kernel = functools.partial(
        _gbm_cliquet_block_kernel, timesteps=timesteps, reset_every=reset_every,
        floor=floor, cap=cap, antithetic=antithetic,
    )
    return _launch(
        kernel, contract_key, contract,
        rows=rows, cols=cols, row_offset=row_offset, interpret=interpret,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "timesteps", "rows", "cols", "payoff", "barrier_rel",
        "antithetic", "term_shapes", "interpret",
    ),
)
def _simulate_term_rows_pallas_f32(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    payoff: PayoffKind,
    term_shapes: tuple[tuple[float, ...], ...],
    barrier_rel: float | None = None,
    antithetic: bool = False,
    row_offset: jax.Array | int = 0,
    interpret: bool = False,
) -> jax.Array:
    kernel = functools.partial(
        _gbm_term_block_kernel, timesteps=timesteps, payoff=payoff,
        barrier_rel=barrier_rel, antithetic=antithetic,
    )
    return _launch(
        kernel, contract_key, contract,
        rows=rows, cols=cols, row_offset=row_offset, interpret=interpret,
        tables=(_term_table(contract, term_shapes, timesteps),),
    )


def simulate_terminal_rows_pallas(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    scheme: PathScheme,
    row_offset: jax.Array | int = 0,
    antithetic_half: int | None = None,
    interpret: bool = False,
) -> jax.Array:
    """Terminal rows from the fused kernel; raises where it cannot run."""
    _check_runnable(
        "simulate_terminal_rows_pallas",
        _shape_ok(dtype=dtype, rows=rows, cols=cols),
        interpret=interpret,
    )
    return _simulate_rows_pallas_f32(
        contract_key,
        contract,
        timesteps=timesteps,
        rows=rows,
        cols=cols,
        scheme=scheme,
        antithetic=antithetic_half is not None,
        row_offset=row_offset,
        interpret=interpret,
    )


def terminal_pathwise_vjp(
    g: jax.Array,
    s_t: jax.Array,
    contract: jax.Array,
    term_factors: tuple[float, float, float] | None = None,
) -> jax.Array:
    """Cotangent on the 6-vector contract from cotangent ``g`` on log-Euler
    terminal values ``s_t`` — WITHOUT re-running the simulation.

    Under log-Euler, ``log S_T = log S0 + (r−q−v²/2)·T + v·√dt·Z`` with
    ``Z = Σ z_t`` a pure function of integer-keyed normals (never of the
    contract), so the per-path stochastic term ``W = v·√dt·Z`` is recoverable
    from the OUTPUT alone: ``W = log(S_T/S0) − (r−q−v²/2)·T``. The full
    pathwise Jacobian follows elementwise:

        ∂logS_T/∂S0 = 1/S0            ∂logS_T/∂K = 0
        ∂logS_T/∂T  = (r−q−v²/2) + W/(2T)
        ∂logS_T/∂r  = T               ∂logS_T/∂q = −T
        ∂logS_T/∂v  = −v·T + W/v

    This is the exact reverse-mode rule for the map the kernel computes (to
    f32 rounding in the W recovery — irrelevant against MC noise), which is
    how the Pallas engine gets Greeks without a kernel backward pass: the
    forward kernel's own samples ARE the residuals.

    ``term_factors = (mv2, mr, mq)`` — (mean(vs²), mean(rs), mean(qs)) of a
    TermStructure's shapes — generalizes the rule to curved markets: the
    contract scalars multiply EVERY step uniformly, so
    ``log S_T = log S0 + (r·mr − q·mq − ½v²·mv2)·T + W`` with the same
    output-only W recovery, and the Jacobian is the flat one with the
    effective factors (∂/∂r = mr·T, ∂/∂v = −v·mv2·T + W/v, …).
    """
    dtype = s_t.dtype
    spot, _, maturity, rate, div_yield, vol = (
        contract[i].astype(dtype) for i in range(6)
    )
    mv2, mr, mq = term_factors if term_factors is not None else (1.0, 1.0, 1.0)
    mu = rate * mr - div_yield * mq - 0.5 * vol * vol * mv2
    w = jnp.log(s_t / spot) - mu * maturity
    gs = g * s_t  # cotangent on log S_T
    total = jnp.sum(gs)
    d_spot = total / spot
    d_mat = jnp.sum(gs * (mu + w / (2.0 * maturity)))
    d_rate = mr * maturity * total
    d_div = -mq * maturity * total
    d_vol = jnp.sum(gs * (-vol * mv2 * maturity + w / vol))
    zero = jnp.zeros((), dtype)
    return jnp.stack([d_spot, zero, d_mat, d_rate, d_div, d_vol]).astype(
        contract.dtype
    )


@functools.lru_cache(maxsize=None)
def _terminal_pallas_diff(
    timesteps: int,
    rows: int,
    cols: int,
    antithetic: bool,
    term_shapes: tuple[tuple[float, ...], ...] | None = None,
    interpret: bool = False,
) -> "jax.custom_vjp":
    if term_shapes is not None:
        vs, rs, qs = term_shapes
        n = float(timesteps)
        factors = (sum(v * v for v in vs) / n, sum(rs) / n, sum(qs) / n)
    else:
        factors = None

    @jax.custom_vjp
    def f(key: jax.Array, contract: jax.Array) -> jax.Array:
        if term_shapes is not None:
            return _simulate_term_rows_pallas_f32(
                key, contract, timesteps=timesteps, rows=rows, cols=cols,
                payoff=PayoffKind.TERMINAL, term_shapes=term_shapes,
                antithetic=antithetic, interpret=interpret,
            )
        return _simulate_rows_pallas_f32(
            key, contract, timesteps=timesteps, rows=rows, cols=cols,
            scheme=PathScheme.LOG_EULER, antithetic=antithetic, interpret=interpret,
        )

    def fwd(key: jax.Array, contract: jax.Array) -> tuple[jax.Array, tuple[jax.Array, jax.Array]]:
        out = f(key, contract)
        return out, (out, contract)

    def bwd(res: tuple[jax.Array, jax.Array], g: jax.Array) -> tuple[None, jax.Array]:
        out, contract = res
        return (None, terminal_pathwise_vjp(g, out, contract, factors))

    f.defvjp(fwd, bwd)
    return f


def simulate_terminal_rows_pallas_diff(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    antithetic_half: int | None = None,
    term: "object | None" = None,
    interpret: bool = False,
) -> jax.Array:
    """Differentiable Pallas terminal simulator (log-Euler TERMINAL only).

    Forward = the fused kernel; backward = the analytic pathwise rule
    (``terminal_pathwise_vjp``) over the kernel's OWN samples — Greeks at
    kernel speed, no recompute, no second bit stream. Curved ``term``
    structures route to the term kernel with the effective-factor backward
    rule; flat ones are the flat program. Raises where the kernel cannot run.
    """
    if term is not None and term.is_flat():
        term = None
    _check_runnable(
        "simulate_terminal_rows_pallas_diff",
        _shape_ok(dtype=dtype, rows=rows, cols=cols),
        interpret=interpret,
    )
    return _terminal_pallas_diff(
        timesteps,
        rows,
        cols,
        antithetic_half is not None,
        term.shapes(timesteps) if term is not None else None,
        interpret,
    )(contract_key, contract)


def simulate_terminal_pallas(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    batches: int,
    network_size: int,
    dtype: jnp.dtype,
    scheme: PathScheme,
    interpret: bool = False,
) -> jax.Array:
    """Flat ``[batches * network_size]`` terminal values (engine-facing API)."""
    return simulate_terminal_rows_pallas(
        contract_key,
        contract,
        timesteps=timesteps,
        rows=batches,
        cols=network_size,
        dtype=dtype,
        scheme=scheme,
        interpret=interpret,
    ).reshape(batches * network_size)


def simulate_underlier_rows_pallas(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    scheme: PathScheme,
    payoff: PayoffKind,
    row_offset: jax.Array | int = 0,
    barrier_rel: float | None = None,
    antithetic_half: int | None = None,
    forward_start_step: int | None = None,
    cliquet_reset_every: int | None = None,
    cliquet_floor: float | None = None,
    cliquet_cap: float | None = None,
    term: "object | None" = None,
    interpret: bool = False,
) -> jax.Array:
    """Payoff underliers (terminal, path average, running extreme, realized
    variance, forward start, cliquet) from the fused GBM kernels.

    A genuinely curved ``term`` routes to the term kernel (stream
    ``gbm_term``, LOG_EULER only); an exactly-flat term is the same program
    as no term. Requests no kernel implements (cliquets or curved terms
    under EULER) raise, as do unsupported shapes and backends.
    """
    if term is not None and term.is_flat():
        term = None  # flat curves are bit-identical to no curves
    ok = _shape_ok(dtype=dtype, rows=rows, cols=cols)
    antithetic = antithetic_half is not None
    if payoff == PayoffKind.CLIQUET:
        assert (  # enforced by build_simulation_params
            cliquet_reset_every is not None
            and cliquet_floor is not None
            and cliquet_cap is not None
        )
        _check_runnable(
            "cliquet kernel (flat log-Euler GBM only)",
            ok and scheme == PathScheme.LOG_EULER and term is None,
            interpret=interpret,
        )
        return _simulate_cliquet_rows_pallas_f32(
            contract_key, contract, timesteps=timesteps, rows=rows, cols=cols,
            reset_every=cliquet_reset_every, floor=cliquet_floor, cap=cliquet_cap,
            antithetic=antithetic, row_offset=row_offset, interpret=interpret,
        )
    _check_runnable(
        "simulate_underlier_rows_pallas",
        ok and (term is None or scheme == PathScheme.LOG_EULER),
        interpret=interpret,
    )
    if payoff == PayoffKind.FORWARD_START:
        # u = spot·S_T/S_m is a TERMINAL walk of the TAIL steps alone, so
        # the forward-start kernel IS the terminal kernel at timesteps' =
        # N−m with the maturity rescaled to preserve dt; curved terms slice
        # their coefficient tables to the tail
        assert forward_start_step is not None  # enforced by build_simulation_params
        m = forward_start_step
        tail = timesteps - m
        contract_tail = contract.at[2].multiply(tail / timesteps)
        if term is not None:
            vs, rs, qs = term.shapes(timesteps)
            return _simulate_term_rows_pallas_f32(
                contract_key, contract_tail, timesteps=tail, rows=rows, cols=cols,
                payoff=PayoffKind.TERMINAL, term_shapes=(vs[m:], rs[m:], qs[m:]),
                antithetic=antithetic, row_offset=row_offset, interpret=interpret,
            )
        return _simulate_rows_pallas_f32(
            contract_key, contract_tail, timesteps=tail, rows=rows, cols=cols,
            scheme=scheme, antithetic=antithetic, row_offset=row_offset,
            interpret=interpret,
        )
    if payoff == PayoffKind.DIGITAL:
        # digital = sign transform of the SAME terminal draw
        terminal = simulate_underlier_rows_pallas(
            contract_key, contract, timesteps=timesteps, rows=rows, cols=cols,
            dtype=dtype, scheme=scheme, payoff=PayoffKind.TERMINAL,
            row_offset=row_offset, antithetic_half=antithetic_half, term=term,
            interpret=interpret,
        )
        strike = contract[1].astype(dtype)
        return strike + jnp.sign(terminal - strike)
    if term is not None:
        return _simulate_term_rows_pallas_f32(
            contract_key, contract, timesteps=timesteps, rows=rows, cols=cols,
            payoff=payoff, term_shapes=term.shapes(timesteps), barrier_rel=barrier_rel,
            antithetic=antithetic, row_offset=row_offset, interpret=interpret,
        )
    return _simulate_rows_pallas_f32(
        contract_key, contract, timesteps=timesteps, rows=rows, cols=cols,
        scheme=scheme, payoff=payoff, barrier_rel=barrier_rel,
        antithetic=antithetic, row_offset=row_offset, interpret=interpret,
    )


# --------------------------------------------------------------------------
# American (LSMC) monitor-row kernels — the forward pass of the Bermudan
# pricer (ops/american.py). They emit the state at every exercise date; the
# backward induction (``encode_monitor_prices``) stays in XLA and is
# byte-identical to the XLA engines', so the engines differ only in the
# forward bit stream.
# --------------------------------------------------------------------------


def _american_shape_ok(
    *, dtype: jnp.dtype, rows: int, cols: int, timesteps: int, exercise_every: int
) -> bool:
    if exercise_every < 1 or timesteps % exercise_every:
        return False
    return (
        _shape_ok(dtype=dtype, rows=rows, cols=cols)
        and 2 <= timesteps // exercise_every <= _MONITOR_MAX_DATES
    )


def pallas_american_supported(
    *, dtype: jnp.dtype, rows: int, cols: int, timesteps: int, exercise_every: int
) -> bool:
    """Whether a fused American monitor-row kernel can honor this request —
    the ``pallas_supported`` contract for ``gbm.resolve_implementation``'s
    AMERICAN branch."""
    return (
        _american_shape_ok(
            dtype=dtype, rows=rows, cols=cols, timesteps=timesteps,
            exercise_every=exercise_every,
        )
        and jax.default_backend() == "gpu"
    )


def _encode_american_rows(
    price_rows: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    exercise_every: int,
    put: bool,
    basis_degree: int,
    axis_name: str | None,
    extra_rows: jax.Array | None = None,
    cross_fit: bool = False,
) -> jax.Array:
    """Backward induction + encode over kernel-emitted monitor rows. Every
    contract layout puts (strike, maturity, rate) at slots 1-3, so one
    encode serves all four dynamics."""
    from spectralmc_tpu.ops.american import encode_monitor_prices

    strike, maturity, rate = (contract[i].astype(jnp.float32) for i in (1, 2, 3))
    dt = maturity / jnp.asarray(timesteps, jnp.float32)
    return encode_monitor_prices(
        price_rows,
        strike=strike,
        maturity=maturity,
        rate=rate,
        disc_monitor=jnp.exp(-rate * dt * jnp.float32(exercise_every)),
        dtype=jnp.float32,
        put=put,
        basis_degree=basis_degree,
        axis_name=axis_name,
        extra_rows=extra_rows,
        cross_fit=cross_fit,
    )


def _monitor_loop(
    rng: _Stream,
    n_monitor: int,
    every: int,
    step: "Callable[[jax.Array, PyTree], PyTree]",
    init: PyTree,
    emit: "Callable[[jax.Array, PyTree], None]",
) -> None:
    """Walk ``n_monitor`` segments of ``every`` steps, calling ``emit(d, state)``
    at each monitor date. Both loops are ``fori_loop``s, so the program size
    does not grow with the number of dates."""

    def segment(d: jax.Array, carry: PyTree) -> PyTree:
        carry = _fori(rng, every, step, carry)
        emit(d, carry)
        return carry

    _fori(rng, n_monitor, segment, init)



def _gbm_monitor_block_kernel(
    params_ref, seeds_ref, out_ref, *,
    block: tuple[int, int], cols: int, timesteps: int, exercise_every: int,
    antithetic: bool,
) -> None:
    """Log-Euler GBM emitting exp(log S) at every monitor date. Within a
    segment only its end is observed, so the terminal kernel's pair-step
    applies: ``exercise_every // 2`` pair steps plus one single step on odd
    segment lengths (stream ``american_gbm``)."""
    rng = _Stream(seeds_ref, block=block, cols=cols, antithetic=antithetic)
    spot, maturity, rate, div_yield, vol = (params_ref[k] for k in (0, 2, 3, 4, 5))
    dt = maturity / jnp.float32(timesteps)
    vol_sdt = vol * jnp.sqrt(dt)
    drift = (rate - div_yield - jnp.float32(0.5) * vol * vol) * dt

    def step_pair(_t: jax.Array, logx: jax.Array) -> jax.Array:
        u1, u2 = rng.pair()
        z_sum = rng.mirror(
            _bm_radius(u1) * jnp.float32(math.sqrt(2.0)) * _sin_turns(u2 + jnp.float32(0.125))
        )
        return logx + jnp.float32(2.0) * drift + vol_sdt * z_sum

    def segment(_t: jax.Array, logx: jax.Array) -> jax.Array:
        logx = _fori(rng, exercise_every // 2, step_pair, logx)
        if exercise_every % 2:
            u1, u2 = rng.pair()
            z = rng.mirror(_bm_radius(u1) * _sin_turns(u2 + jnp.float32(0.25)))
            logx = logx + drift + vol_sdt * z
        return logx

    def emit(d: jax.Array, logx: jax.Array) -> None:
        out_ref[d] = jnp.exp(logx)

    log0 = jnp.full(block, 0.0, jnp.float32) + jnp.log(spot)
    _monitor_loop(rng, timesteps // exercise_every, 1, segment, log0, emit)


@functools.partial(
    jax.jit,
    static_argnames=(
        "timesteps", "rows", "cols", "put", "basis_degree", "exercise_every",
        "antithetic", "axis_name", "interpret", "cross_fit",
    ),
)
def _simulate_american_rows_pallas_f32(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    put: bool,
    basis_degree: int,
    exercise_every: int,
    antithetic: bool = False,
    row_offset: jax.Array | int = 0,
    axis_name: str | None = None,
    cross_fit: bool = False,
    interpret: bool = False,
) -> jax.Array:
    from spectralmc_tpu.ops.american import check_monitor_grid

    check_monitor_grid(timesteps, exercise_every)
    kernel = functools.partial(
        _gbm_monitor_block_kernel, timesteps=timesteps,
        exercise_every=exercise_every, antithetic=antithetic,
    )
    price_rows = _launch(
        kernel, contract_key, contract, rows=rows, cols=cols,
        row_offset=row_offset, interpret=interpret,
        monitors=timesteps // exercise_every,
    )
    return _encode_american_rows(
        price_rows, contract,
        timesteps=timesteps, exercise_every=exercise_every,
        put=put, basis_degree=basis_degree, axis_name=axis_name,
        cross_fit=cross_fit,
    )


def _check_american(
    what: str, *, interpret: bool, dtype: jnp.dtype, rows: int, cols: int,
    timesteps: int, exercise_every: int,
) -> None:
    _check_runnable(
        what,
        _american_shape_ok(
            dtype=dtype, rows=rows, cols=cols, timesteps=timesteps,
            exercise_every=exercise_every,
        ),
        interpret=interpret,
    )


def simulate_american_underlier_rows_pallas(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    option: "object",
    basis_degree: int = 5,
    exercise_every: int = 1,
    row_offset: jax.Array | int = 0,
    antithetic_half: int | None = None,
    axis_name: str | None = None,
    cross_fit: bool = False,
    interpret: bool = False,
) -> jax.Array:
    """``[rows, cols]`` synthetic AMERICAN underliers with the fused
    monitor-row kernel as the forward pass (ops/american.py docstring for
    the encoding contract); the backward induction is the XLA engine's
    ``encode_monitor_prices``. Raises where the kernel cannot run."""
    from spectralmc_tpu.ops.greeks import OptionSide

    _check_american(
        "simulate_american_underlier_rows_pallas", interpret=interpret,
        dtype=dtype, rows=rows, cols=cols, timesteps=timesteps,
        exercise_every=exercise_every,
    )
    return _simulate_american_rows_pallas_f32(
        contract_key,
        contract,
        timesteps=timesteps,
        rows=rows,
        cols=cols,
        put=option == OptionSide.PUT,
        basis_degree=basis_degree,
        exercise_every=exercise_every,
        antithetic=antithetic_half is not None,
        row_offset=row_offset,
        axis_name=axis_name,
        cross_fit=cross_fit,
        interpret=interpret,
    )


# --------------------------------------------------------------------------
# Heston kernel (second model family; ops/heston.py defines the XLA path)
# --------------------------------------------------------------------------


class _HestonStep:
    """One full-truncation Euler step of (log S, v) from one Box–Muller
    pair: z_v = r·cos drives the variance, the orthogonal part r·sin the
    spot. Shared by the European and the monitor-row kernels."""

    def __init__(self, params_ref, rng: _Stream, timesteps: int) -> None:
        maturity, rate, div_yield = params_ref[2], params_ref[3], params_ref[4]
        kappa, theta, xi, rho = (params_ref[k] for k in range(6, 10))
        self.rng = rng
        self.dt = maturity / jnp.float32(timesteps)
        self.rho = rho
        self.rho_bar = jnp.sqrt(jnp.float32(1.0) - rho * rho)
        self.rq_dt = (rate - div_yield) * self.dt
        # full truncation keeps RAW v as the base (only drift/diffusion see v+)
        self.kdt = kappa * self.dt
        self.ktheta_dt = kappa * theta * self.dt
        self.xi = xi

    def __call__(self, logx: jax.Array, v: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
        """(log-increment, new logx, new v)."""
        u1, u2 = self.rng.pair()
        radius = _bm_radius(u1)
        sin_t, cos_t = _sincos_turns(u2)
        z_v = self.rng.mirror(radius * cos_t)
        z_s = self.rho * z_v + self.rho_bar * self.rng.mirror(radius * sin_t)
        v_plus = jnp.maximum(v, jnp.float32(0.0))
        sqrt_v_sdt = jnp.sqrt(v_plus * self.dt)
        inc = self.rq_dt - jnp.float32(0.5) * v_plus * self.dt + sqrt_v_sdt * z_s
        v = v + self.ktheta_dt - self.kdt * v_plus + self.xi * sqrt_v_sdt * z_v
        return inc, logx + inc, v


def _heston_block_kernel(
    params_ref, seeds_ref, out_ref, *,
    block: tuple[int, int], cols: int, timesteps: int, payoff: PayoffKind,
    barrier_rel: float | None = None, antithetic: bool = False,
    forward_start_step: int | None = None,
) -> None:
    """Fused Heston (stream ``heston``): one Box–Muller pair per step."""
    rng = _Stream(seeds_ref, block=block, cols=cols, antithetic=antithetic)
    step_fn = _HestonStep(params_ref, rng, timesteps)
    spot, strike, maturity, v0 = params_ref[0], params_ref[1], params_ref[2], params_ref[5]

    geometric = payoff == PayoffKind.ASIAN_GEOMETRIC
    barrier = payoff in BARRIER_PAYOFFS
    lookback, up, extreme_fn = _extreme_kind(payoff)
    variance = payoff == PayoffKind.VARIANCE_SWAP
    track_extreme = barrier or lookback

    def step(t: jax.Array, carry: tuple[jax.Array, jax.Array, jax.Array]) -> tuple[jax.Array, jax.Array, jax.Array]:
        logx, v, acc = carry
        inc, logx, v = step_fn(logx, v)
        if payoff == PayoffKind.FORWARD_START:
            # the variance couples S_m to the tail: capture ln S_m (state
            # after step m−1)
            acc = jnp.where(t == forward_start_step - 1, logx, acc)
        elif variance:
            acc = acc + inc * inc
        elif track_extreme:
            acc = extreme_fn(acc, logx)
        elif payoff != PayoffKind.TERMINAL:
            acc = acc + (logx if geometric else jnp.exp(logx))
        return (logx, v, acc)

    log0 = jnp.full(block, 0.0, jnp.float32) + jnp.log(spot)
    vinit = jnp.full(block, 0.0, jnp.float32) + v0
    keep_log = track_extreme or payoff == PayoffKind.FORWARD_START
    logx, _, acc = _fori(
        rng, timesteps, step, (log0, vinit, log0 if keep_log else jnp.zeros(block, jnp.float32))
    )
    inv_n = jnp.float32(1.0 / timesteps)
    if payoff == PayoffKind.FORWARD_START:
        out_ref[...] = spot * jnp.exp(logx - acc)  # spot·S_T/S_m
    elif lookback:
        out_ref[...] = lookback_underlier(payoff, strike, jnp.exp(acc), jnp.exp(logx))
    elif barrier:
        level = jnp.log(spot * jnp.float32(barrier_rel))
        knocked = acc >= level if up else acc <= level
        out_ref[...] = jnp.where(knocked, strike, jnp.exp(logx))
    elif payoff == PayoffKind.TERMINAL:
        out_ref[...] = jnp.exp(logx)
    elif variance:
        out_ref[...] = acc / maturity  # annualized RV (ops/gbm.py::PayoffKind)
    elif geometric:
        out_ref[...] = jnp.exp(acc * inv_n)
    else:
        out_ref[...] = acc * inv_n


@functools.partial(
    jax.jit,
    static_argnames=(
        "timesteps", "rows", "cols", "payoff", "barrier_rel", "antithetic",
        "forward_start_step", "interpret",
    ),
)
def _simulate_heston_rows_pallas_f32(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    payoff: PayoffKind,
    barrier_rel: float | None = None,
    antithetic: bool = False,
    forward_start_step: int | None = None,
    row_offset: jax.Array | int = 0,
    interpret: bool = False,
) -> jax.Array:
    kernel = functools.partial(
        _heston_block_kernel, timesteps=timesteps, payoff=payoff,
        barrier_rel=barrier_rel, antithetic=antithetic,
        forward_start_step=forward_start_step,
    )
    return _launch(
        kernel, contract_key, contract,
        rows=rows, cols=cols, row_offset=row_offset, interpret=interpret,
    )


def simulate_heston_underlier_rows_pallas(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    payoff: PayoffKind,
    row_offset: jax.Array | int = 0,
    barrier_rel: float | None = None,
    antithetic_half: int | None = None,
    forward_start_step: int | None = None,
    interpret: bool = False,
) -> jax.Array:
    """Fused Heston kernel; raises where it cannot run."""
    _check_runnable(
        "simulate_heston_underlier_rows_pallas",
        _shape_ok(dtype=dtype, rows=rows, cols=cols),
        interpret=interpret,
    )
    if payoff == PayoffKind.DIGITAL:
        # digital = sign transform of the SAME terminal draw
        terminal = simulate_heston_underlier_rows_pallas(
            contract_key, contract, timesteps=timesteps, rows=rows, cols=cols,
            dtype=dtype, payoff=PayoffKind.TERMINAL, row_offset=row_offset,
            antithetic_half=antithetic_half, interpret=interpret,
        )
        strike = contract[1].astype(dtype)
        return strike + jnp.sign(terminal - strike)
    return _simulate_heston_rows_pallas_f32(
        contract_key, contract, timesteps=timesteps, rows=rows, cols=cols,
        payoff=payoff, barrier_rel=barrier_rel,
        antithetic=antithetic_half is not None,
        forward_start_step=forward_start_step, row_offset=row_offset,
        interpret=interpret,
    )


def _heston_monitor_block_kernel(
    params_ref, seeds_ref, price_ref, var_ref, *,
    block: tuple[int, int], cols: int, timesteps: int, exercise_every: int,
    antithetic: bool,
) -> None:
    """Heston emitting (exp(log S), v+) per monitor date — both state
    variables, because the continuation value depends on the variance too
    (ops/american.py basis augmentation). Stream ``american_heston``."""
    rng = _Stream(seeds_ref, block=block, cols=cols, antithetic=antithetic)
    step_fn = _HestonStep(params_ref, rng, timesteps)

    def step(_t: jax.Array, carry: tuple[jax.Array, jax.Array]) -> tuple[jax.Array, jax.Array]:
        _, logx, v = step_fn(*carry)
        return (logx, v)

    logx = jnp.full(block, 0.0, jnp.float32) + jnp.log(params_ref[0])
    v = jnp.full(block, 0.0, jnp.float32) + params_ref[5]
    def emit(d: jax.Array, carry: tuple[jax.Array, jax.Array]) -> None:
        price_ref[d] = jnp.exp(carry[0])
        var_ref[d] = jnp.maximum(carry[1], jnp.float32(0.0))

    _monitor_loop(rng, timesteps // exercise_every, exercise_every, step, (logx, v), emit)


@functools.partial(
    jax.jit,
    static_argnames=(
        "timesteps", "rows", "cols", "put", "basis_degree", "exercise_every",
        "antithetic", "axis_name", "interpret", "cross_fit",
    ),
)
def _simulate_heston_american_rows_pallas_f32(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    put: bool,
    basis_degree: int,
    exercise_every: int,
    antithetic: bool = False,
    row_offset: jax.Array | int = 0,
    axis_name: str | None = None,
    cross_fit: bool = False,
    interpret: bool = False,
) -> jax.Array:
    from spectralmc_tpu.ops.american import check_monitor_grid

    check_monitor_grid(timesteps, exercise_every)
    kernel = functools.partial(
        _heston_monitor_block_kernel, timesteps=timesteps,
        exercise_every=exercise_every, antithetic=antithetic,
    )
    price_rows, var_rows = _launch(
        kernel, contract_key, contract, rows=rows, cols=cols,
        row_offset=row_offset, interpret=interpret,
        monitors=timesteps // exercise_every, n_out=2,
    )
    return _encode_american_rows(
        price_rows, contract,
        timesteps=timesteps, exercise_every=exercise_every,
        put=put, basis_degree=basis_degree, axis_name=axis_name,
        extra_rows=var_rows, cross_fit=cross_fit,
    )


def simulate_heston_american_underlier_rows_pallas(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    option: "object",
    basis_degree: int = 5,
    exercise_every: int = 1,
    row_offset: jax.Array | int = 0,
    antithetic_half: int | None = None,
    axis_name: str | None = None,
    cross_fit: bool = False,
    interpret: bool = False,
) -> jax.Array:
    """Heston American underliers via the fused monitor-row kernel; the
    variance-augmented backward induction is the XLA engine's. Raises where
    the kernel cannot run."""
    from spectralmc_tpu.ops.greeks import OptionSide

    _check_american(
        "simulate_heston_american_underlier_rows_pallas", interpret=interpret,
        dtype=dtype, rows=rows, cols=cols, timesteps=timesteps,
        exercise_every=exercise_every,
    )
    return _simulate_heston_american_rows_pallas_f32(
        contract_key, contract, timesteps=timesteps, rows=rows, cols=cols,
        put=option == OptionSide.PUT, basis_degree=basis_degree,
        exercise_every=exercise_every, antithetic=antithetic_half is not None,
        row_offset=row_offset, axis_name=axis_name, cross_fit=cross_fit,
        interpret=interpret,
    )


# --------------------------------------------------------------------------
# Basket kernel (third model family; ops/basket.py defines the XLA path)
# --------------------------------------------------------------------------


class _BasketStep:
    """A correlated log-Euler components per path. The basket structure
    (weights, multipliers, Cholesky rows) is static per BasketSpec and baked
    in as immediates — the A×A mix is an unrolled lower-triangular FMA chain
    in registers. Assets (2a, 2a+1) take r·cos / r·sin of ONE Box–Muller
    draw, so A assets cost ⌈A/2⌉ draws per step."""

    def __init__(
        self, params_ref, rng: _Stream, *, timesteps: int, weights: tuple[float, ...],
        spot_multipliers: tuple[float, ...], vol_multipliers: tuple[float, ...],
        chol: tuple[tuple[float, ...], ...], geometric_combine: bool,
    ) -> None:
        spot, maturity, rate, div_yield, vol = (params_ref[k] for k in (0, 2, 3, 4, 5))
        dt = maturity / jnp.float32(timesteps)
        sqrt_dt = jnp.sqrt(dt)
        self.rng = rng
        self.weights = weights
        self.chol = chol
        self.geometric_combine = geometric_combine
        self.sig_sdt = [vol * jnp.float32(m) * sqrt_dt for m in vol_multipliers]
        self.drift = [
            (rate - div_yield - jnp.float32(0.5) * (vol * jnp.float32(m)) ** 2) * dt
            for m in vol_multipliers
        ]
        self.spot_multipliers = spot_multipliers
        self.spot = spot

    def initial(self, block: tuple[int, int]) -> tuple[jax.Array, ...]:
        return tuple(
            jnp.full(block, 0.0, jnp.float32) + jnp.log(self.spot * jnp.float32(m))
            for m in self.spot_multipliers
        )

    def log_geometric(self, logx: tuple[jax.Array, ...]) -> jax.Array:
        lg = jnp.float32(self.weights[0]) * logx[0]
        for a in range(1, len(self.weights)):
            lg = lg + jnp.float32(self.weights[a]) * logx[a]
        return lg

    def arithmetic(self, logx: tuple[jax.Array, ...]) -> jax.Array:
        acc = jnp.float32(self.weights[0]) * jnp.exp(logx[0])
        for a in range(1, len(self.weights)):
            acc = acc + jnp.float32(self.weights[a]) * jnp.exp(logx[a])
        return acc

    def value(self, logx: tuple[jax.Array, ...]) -> jax.Array:
        if self.geometric_combine:
            return jnp.exp(self.log_geometric(logx))
        return self.arithmetic(logx)

    def __call__(self, logx: tuple[jax.Array, ...]) -> tuple[jax.Array, ...]:
        a_n = len(self.weights)
        z: list[jax.Array] = []
        for _pair in range((a_n + 1) // 2):
            u1, u2 = self.rng.pair()
            radius = _bm_radius(u1)
            sin_t, cos_t = _sincos_turns(u2)
            z.append(self.rng.mirror(radius * cos_t))
            if len(z) < a_n:
                z.append(self.rng.mirror(radius * sin_t))
        new_logx = []
        for a in range(a_n):
            zm = jnp.float32(self.chol[a][0]) * z[0]
            for b in range(1, a + 1):
                if self.chol[a][b] != 0.0:
                    zm = zm + jnp.float32(self.chol[a][b]) * z[b]
            new_logx.append(logx[a] + self.drift[a] + self.sig_sdt[a] * zm)
        return tuple(new_logx)


def _basket_block_kernel(
    params_ref, seeds_ref, out_ref, *,
    block: tuple[int, int], cols: int, timesteps: int, payoff: PayoffKind,
    structure: dict, barrier_rel: float | None = None, antithetic: bool = False,
    forward_start_step: int | None = None,
) -> None:
    """Fused multi-asset GBM (stream ``basket_gbm``)."""
    rng = _Stream(seeds_ref, block=block, cols=cols, antithetic=antithetic)
    step_fn = _BasketStep(params_ref, rng, timesteps=timesteps, **structure)
    spot, strike, maturity = params_ref[0], params_ref[1], params_ref[2]
    log0 = step_fn.initial(block)
    zeros = jnp.zeros(block, jnp.float32)

    if payoff == PayoffKind.FORWARD_START:
        # arithmetic combine reaches here (the wrapper routes the geometric
        # combine through the terminal-tail trick): capture B_m
        def step_fs(t: jax.Array, carry: tuple[tuple[jax.Array, ...], jax.Array]) -> tuple[tuple[jax.Array, ...], jax.Array]:
            logx, cap = carry
            logx = step_fn(logx)
            return (logx, jnp.where(t == forward_start_step - 1, step_fn.value(logx), cap))

        b0 = step_fn.value(log0)
        logx_f, cap_f = _fori(rng, timesteps, step_fs, (log0, b0))
        out_ref[...] = b0 * step_fn.value(logx_f) / cap_f  # u = B₀·B_T/B_m
        return

    if payoff == PayoffKind.VARIANCE_SWAP:
        # realized variance of the BASKET value (combine convention)
        def log_value(logx: tuple[jax.Array, ...]) -> jax.Array:
            if step_fn.geometric_combine:
                return step_fn.log_geometric(logx)
            return jnp.log(step_fn.arithmetic(logx))

        def step_var(_t: jax.Array, carry: tuple) -> tuple:
            logx, prev_lb, acc = carry
            logx = step_fn(logx)
            lb = log_value(logx)
            inc = lb - prev_lb
            return (logx, lb, acc + inc * inc)

        _, _, acc_v = _fori(rng, timesteps, step_var, (log0, log_value(log0), zeros))
        out_ref[...] = acc_v / maturity
        return

    geometric_time = payoff == PayoffKind.ASIAN_GEOMETRIC
    barrier = payoff in BARRIER_PAYOFFS
    lookback, up, extreme_fn = _extreme_kind(payoff)
    track_extreme = barrier or lookback
    terminal = payoff == PayoffKind.TERMINAL

    def step(_t: jax.Array, carry: tuple) -> tuple:
        logx, acc = carry
        logx = step_fn(logx)
        if track_extreme:
            acc = extreme_fn(acc, step_fn.value(logx))
        elif not terminal:
            value = step_fn.value(logx)
            acc = acc + (jnp.log(value) if geometric_time else value)
        return (logx, acc)

    acc0 = step_fn.value(log0) if track_extreme else zeros
    logx, acc = _fori(rng, timesteps, step, (log0, acc0))
    inv_n = jnp.float32(1.0 / timesteps)
    if lookback:
        out_ref[...] = lookback_underlier(payoff, strike, acc, step_fn.value(logx))
    elif barrier:
        # level = initial basket value x barrier_rel (matches the XLA path)
        weights, mults = structure["weights"], structure["spot_multipliers"]
        if step_fn.geometric_combine:
            g0 = math.exp(sum(w * math.log(m) for w, m in zip(weights, mults)))
        else:
            g0 = sum(w * m for w, m in zip(weights, mults))
        level = spot * jnp.float32(g0 * barrier_rel)
        knocked = acc >= level if up else acc <= level
        out_ref[...] = jnp.where(knocked, strike, step_fn.value(logx))
    elif terminal:
        out_ref[...] = step_fn.value(logx)
    elif geometric_time:
        out_ref[...] = jnp.exp(acc * inv_n)
    else:
        out_ref[...] = acc * inv_n


def _basket_structure(spec: "object") -> dict:
    from spectralmc_tpu.ops.basket import BasketCombine, basket_cholesky

    return dict(
        weights=tuple(spec.weights),
        spot_multipliers=tuple(spec.spot_multipliers),
        vol_multipliers=tuple(spec.vol_multipliers),
        chol=tuple(tuple(float(x) for x in row) for row in basket_cholesky(spec)),
        geometric_combine=spec.combine == BasketCombine.GEOMETRIC,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "spec", "timesteps", "rows", "cols", "payoff", "barrier_rel", "antithetic",
        "forward_start_step", "interpret",
    ),
)
def _simulate_basket_rows_pallas_f32(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    spec: "object",
    timesteps: int,
    rows: int,
    cols: int,
    payoff: PayoffKind,
    barrier_rel: float | None = None,
    antithetic: bool = False,
    forward_start_step: int | None = None,
    row_offset: jax.Array | int = 0,
    interpret: bool = False,
) -> jax.Array:
    kernel = functools.partial(
        _basket_block_kernel, timesteps=timesteps, payoff=payoff,
        structure=_basket_structure(spec), barrier_rel=barrier_rel,
        antithetic=antithetic, forward_start_step=forward_start_step,
    )
    return _launch(
        kernel, contract_key, contract,
        rows=rows, cols=cols, row_offset=row_offset, interpret=interpret,
    )


def simulate_basket_underlier_rows_pallas(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    spec: "object",
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    payoff: PayoffKind,
    row_offset: jax.Array | int = 0,
    barrier_rel: float | None = None,
    antithetic_half: int | None = None,
    forward_start_step: int | None = None,
    interpret: bool = False,
) -> jax.Array:
    """Fused basket kernel; raises where it cannot run."""
    from spectralmc_tpu.ops.basket import BasketCombine

    _check_runnable(
        "simulate_basket_underlier_rows_pallas",
        _shape_ok(dtype=dtype, rows=rows, cols=cols),
        interpret=interpret,
    )
    if payoff == PayoffKind.FORWARD_START and spec.combine == BasketCombine.GEOMETRIC:
        # the geometric combine's B_T/B_m is the effective GBM's tail ratio:
        # the terminal kernel at the tail length, maturity rescaled
        assert forward_start_step is not None
        tail = timesteps - forward_start_step
        payoff, timesteps = PayoffKind.TERMINAL, tail
        contract = contract.at[2].multiply(tail / (tail + forward_start_step))
        forward_start_step = None
    if payoff == PayoffKind.DIGITAL:
        # digital = sign transform of the SAME terminal draw
        terminal = simulate_basket_underlier_rows_pallas(
            contract_key, contract, spec=spec, timesteps=timesteps, rows=rows,
            cols=cols, dtype=dtype, payoff=PayoffKind.TERMINAL,
            row_offset=row_offset, antithetic_half=antithetic_half,
            interpret=interpret,
        )
        strike = contract[1].astype(dtype)
        return strike + jnp.sign(terminal - strike)
    return _simulate_basket_rows_pallas_f32(
        contract_key, contract, spec=spec, timesteps=timesteps, rows=rows,
        cols=cols, payoff=payoff, barrier_rel=barrier_rel,
        antithetic=antithetic_half is not None,
        forward_start_step=forward_start_step, row_offset=row_offset,
        interpret=interpret,
    )


def _basket_monitor_block_kernel(
    params_ref, seeds_ref, price_ref, disp_ref, *,
    block: tuple[int, int], cols: int, timesteps: int, exercise_every: int,
    structure: dict, antithetic: bool,
) -> None:
    """Correlated multi-asset GBM emitting the combined BASKET value and,
    for arithmetic combines, the log dispersion ln(B_arith/B_geom) — the
    second regression state — per monitor date (stream
    ``american_basket_gbm``). Geometric combines write zero dispersion rows
    (ln B is Markov), which the launch drops."""
    rng = _Stream(seeds_ref, block=block, cols=cols, antithetic=antithetic)
    step_fn = _BasketStep(params_ref, rng, timesteps=timesteps, **structure)
    logx = step_fn.initial(block)

    def emit(d: jax.Array, logx: tuple[jax.Array, ...]) -> None:
        lg = step_fn.log_geometric(logx)
        if step_fn.geometric_combine:
            price_ref[d] = jnp.exp(lg)
            disp_ref[d] = jnp.zeros(block, jnp.float32)
        else:
            b_arith = step_fn.arithmetic(logx)
            price_ref[d] = b_arith
            disp_ref[d] = jnp.log(b_arith) - lg

    _monitor_loop(
        rng, timesteps // exercise_every, exercise_every,
        lambda _t, c: step_fn(c), logx, emit,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "spec", "timesteps", "rows", "cols", "put", "basis_degree",
        "exercise_every", "antithetic", "axis_name", "interpret", "cross_fit",
    ),
)
def _simulate_basket_american_rows_pallas_f32(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    spec: "object",
    timesteps: int,
    rows: int,
    cols: int,
    put: bool,
    basis_degree: int,
    exercise_every: int,
    antithetic: bool = False,
    row_offset: jax.Array | int = 0,
    axis_name: str | None = None,
    cross_fit: bool = False,
    interpret: bool = False,
) -> jax.Array:
    from spectralmc_tpu.ops.american import check_monitor_grid

    check_monitor_grid(timesteps, exercise_every)
    structure = _basket_structure(spec)
    kernel = functools.partial(
        _basket_monitor_block_kernel, timesteps=timesteps,
        exercise_every=exercise_every, structure=structure, antithetic=antithetic,
    )
    price_rows, disp_rows = _launch(
        kernel, contract_key, contract, rows=rows, cols=cols,
        row_offset=row_offset, interpret=interpret,
        monitors=timesteps // exercise_every, n_out=2,
    )
    return _encode_american_rows(
        price_rows, contract,
        timesteps=timesteps, exercise_every=exercise_every,
        put=put, basis_degree=basis_degree, axis_name=axis_name,
        extra_rows=None if structure["geometric_combine"] else disp_rows,
        cross_fit=cross_fit,
    )


def simulate_basket_american_underlier_rows_pallas(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    spec: "object",
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    option: "object",
    basis_degree: int = 5,
    exercise_every: int = 1,
    row_offset: jax.Array | int = 0,
    antithetic_half: int | None = None,
    axis_name: str | None = None,
    cross_fit: bool = False,
    interpret: bool = False,
) -> jax.Array:
    """Basket American underliers via the fused monitor-row kernel. Exercise
    compares strike against the COMBINED basket value; arithmetic combines
    carry the log dispersion as the second regression state. Raises where
    the kernel cannot run."""
    from spectralmc_tpu.ops.greeks import OptionSide

    _check_american(
        "simulate_basket_american_underlier_rows_pallas", interpret=interpret,
        dtype=dtype, rows=rows, cols=cols, timesteps=timesteps,
        exercise_every=exercise_every,
    )
    return _simulate_basket_american_rows_pallas_f32(
        contract_key, contract, spec=spec, timesteps=timesteps, rows=rows,
        cols=cols, put=option == OptionSide.PUT, basis_degree=basis_degree,
        exercise_every=exercise_every, antithetic=antithetic_half is not None,
        row_offset=row_offset, axis_name=axis_name, cross_fit=cross_fit,
        interpret=interpret,
    )


# --------------------------------------------------------------------------
# Merton kernel (fourth model family; ops/merton.py defines the XLA path)
# --------------------------------------------------------------------------


# Static inverse-CDF depth: counts cap at 16 per step. For lam*dt <= ~3.2
# the cap is UNREACHABLE — P(N > 16) < 2^-24, and a 24-bit uniform can never
# land in tail mass below 2^-24, so the capped sampler emits exactly the
# counts an unbounded inverse CDF would. Beyond that (> 3.2 expected jumps
# PER STEP) counts saturate at 16 with bias P(N > 16).
_POISSON_TERMS = 16


def _poisson_counts(u: jax.Array, mu: jax.Array) -> jax.Array:
    """Inverse-CDF Poisson(mu) counts from one uniform per lane.

    The pmf recursion p_k = p_{k-1}*mu/k and its running cdf are SCALARS
    (they depend only on mu), so each of the ``_POISSON_TERMS`` statically
    unrolled levels costs ONE vector compare+add: a lane's count is the
    number of cdf levels at or below its uniform. jax.random.poisson (the
    XLA path) is a different bit stream entirely.
    """
    p = jnp.exp(-mu)
    cdf = p
    cnt = jnp.zeros_like(u)
    for k in range(1, _POISSON_TERMS + 1):
        cnt = cnt + jnp.where(u >= cdf, jnp.float32(1.0), jnp.float32(0.0))
        p = p * mu / jnp.float32(k)
        cdf = cdf + p
    return cnt


class _MertonStep:
    """Exact Merton transition: ONE Box–Muller pair supplies the diffusion
    (z_d = r·cos) and the jump-size Gaussian (z_j = r·sin), ONE more draw
    the inverse-CDF Poisson count. Antithetic partners negate the Gaussian
    pair and SHARE the counts (common random numbers for the jump channel,
    the pathwise-Greeks CRN contract of ops/merton.py) — the interleaved
    pairing gives both partners the same count draw by construction."""

    def __init__(self, params_ref, rng: _Stream, timesteps: int) -> None:
        maturity, rate, div_yield, vol = (params_ref[k] for k in range(2, 6))
        lam, self.jump_mean, self.jump_std = params_ref[6], params_ref[7], params_ref[8]
        dt = maturity / jnp.float32(timesteps)
        self.rng = rng
        self.vol_sdt = vol * jnp.sqrt(dt)
        # -lam*m compensator keeps the discounted spot a martingale
        m = jnp.exp(self.jump_mean + jnp.float32(0.5) * self.jump_std * self.jump_std) - jnp.float32(1.0)
        self.drift = (rate - div_yield - lam * m - jnp.float32(0.5) * vol * vol) * dt
        self.lam_dt = lam * dt

    def __call__(self) -> jax.Array:
        """One log-increment."""
        u1, u2 = self.rng.pair()
        radius = _bm_radius(u1)
        sin_t, cos_t = _sincos_turns(u2)
        z_d = self.rng.mirror(radius * cos_t)
        z_j = self.rng.mirror(radius * sin_t)
        counts = _poisson_counts(self.rng.uniform(), self.lam_dt)
        jump = counts * self.jump_mean + self.jump_std * jnp.sqrt(counts) * z_j
        return self.drift + self.vol_sdt * z_d + jump


def _merton_block_kernel(
    params_ref, seeds_ref, out_ref, *,
    block: tuple[int, int], cols: int, timesteps: int, payoff: PayoffKind,
    barrier_rel: float | None = None, antithetic: bool = False,
) -> None:
    """Fused Merton jump-diffusion (stream ``merton_jump``)."""
    rng = _Stream(seeds_ref, block=block, cols=cols, antithetic=antithetic)
    step_fn = _MertonStep(params_ref, rng, timesteps)
    spot, strike, maturity = params_ref[0], params_ref[1], params_ref[2]
    geometric = payoff == PayoffKind.ASIAN_GEOMETRIC
    barrier = payoff in BARRIER_PAYOFFS
    lookback, up, extreme_fn = _extreme_kind(payoff)
    variance = payoff == PayoffKind.VARIANCE_SWAP
    track_extreme = barrier or lookback

    def step(_t: jax.Array, carry: tuple[jax.Array, jax.Array]) -> tuple[jax.Array, jax.Array]:
        logx, acc = carry
        inc = step_fn()
        logx = logx + inc
        if variance:
            acc = acc + inc * inc
        elif track_extreme:
            acc = extreme_fn(acc, logx)
        elif payoff != PayoffKind.TERMINAL:
            acc = acc + (logx if geometric else jnp.exp(logx))
        return (logx, acc)

    log0 = jnp.full(block, 0.0, jnp.float32) + jnp.log(spot)
    logx, acc = _fori(
        rng, timesteps, step, (log0, log0 if track_extreme else jnp.zeros(block, jnp.float32))
    )
    inv_n = jnp.float32(1.0 / timesteps)
    if lookback:
        out_ref[...] = lookback_underlier(payoff, strike, jnp.exp(acc), jnp.exp(logx))
    elif barrier:
        level = jnp.log(spot * jnp.float32(barrier_rel))
        knocked = acc >= level if up else acc <= level
        out_ref[...] = jnp.where(knocked, strike, jnp.exp(logx))
    elif payoff == PayoffKind.TERMINAL:
        out_ref[...] = jnp.exp(logx)
    elif variance:
        out_ref[...] = acc / maturity  # annualized RV (ops/gbm.py::PayoffKind)
    elif geometric:
        out_ref[...] = jnp.exp(acc * inv_n)
    else:
        out_ref[...] = acc * inv_n


@functools.partial(
    jax.jit,
    static_argnames=(
        "timesteps", "rows", "cols", "payoff", "barrier_rel", "antithetic", "interpret"
    ),
)
def _simulate_merton_rows_pallas_f32(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    payoff: PayoffKind,
    barrier_rel: float | None = None,
    antithetic: bool = False,
    row_offset: jax.Array | int = 0,
    interpret: bool = False,
) -> jax.Array:
    kernel = functools.partial(
        _merton_block_kernel, timesteps=timesteps, payoff=payoff,
        barrier_rel=barrier_rel, antithetic=antithetic,
    )
    return _launch(
        kernel, contract_key, contract,
        rows=rows, cols=cols, row_offset=row_offset, interpret=interpret,
    )


def simulate_merton_underlier_rows_pallas(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    payoff: PayoffKind,
    row_offset: jax.Array | int = 0,
    barrier_rel: float | None = None,
    antithetic_half: int | None = None,
    forward_start_step: int | None = None,
    interpret: bool = False,
) -> jax.Array:
    """Fused Merton kernel; raises where it cannot run."""
    _check_runnable(
        "simulate_merton_underlier_rows_pallas",
        _shape_ok(dtype=dtype, rows=rows, cols=cols),
        interpret=interpret,
    )
    if payoff == PayoffKind.FORWARD_START:
        # exact transitions make the tail independent of S_m: the terminal
        # kernel at the tail length with maturity rescaled to preserve dt
        assert forward_start_step is not None
        tail = timesteps - forward_start_step
        return _simulate_merton_rows_pallas_f32(
            contract_key, contract.at[2].multiply(tail / timesteps),
            timesteps=tail, rows=rows, cols=cols, payoff=PayoffKind.TERMINAL,
            antithetic=antithetic_half is not None, row_offset=row_offset,
            interpret=interpret,
        )
    if payoff == PayoffKind.DIGITAL:
        # digital = sign transform of the SAME terminal draw
        terminal = simulate_merton_underlier_rows_pallas(
            contract_key, contract, timesteps=timesteps, rows=rows, cols=cols,
            dtype=dtype, payoff=PayoffKind.TERMINAL, row_offset=row_offset,
            antithetic_half=antithetic_half, interpret=interpret,
        )
        strike = contract[1].astype(dtype)
        return strike + jnp.sign(terminal - strike)
    return _simulate_merton_rows_pallas_f32(
        contract_key, contract, timesteps=timesteps, rows=rows, cols=cols,
        payoff=payoff, barrier_rel=barrier_rel,
        antithetic=antithetic_half is not None, row_offset=row_offset,
        interpret=interpret,
    )


def _merton_monitor_block_kernel(
    params_ref, seeds_ref, out_ref, *,
    block: tuple[int, int], cols: int, timesteps: int, exercise_every: int,
    antithetic: bool,
) -> None:
    """Merton emitting exp(log S) per monitor date, one exact step per
    timestep (stream ``american_merton_jump``). The spot alone is Markov, so
    only price rows are emitted."""
    rng = _Stream(seeds_ref, block=block, cols=cols, antithetic=antithetic)
    step_fn = _MertonStep(params_ref, rng, timesteps)
    logx = jnp.full(block, 0.0, jnp.float32) + jnp.log(params_ref[0])

    def emit(d: jax.Array, x: jax.Array) -> None:
        out_ref[d] = jnp.exp(x)

    _monitor_loop(
        rng, timesteps // exercise_every, exercise_every,
        lambda _t, x: x + step_fn(), logx, emit,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "timesteps", "rows", "cols", "put", "basis_degree", "exercise_every",
        "antithetic", "axis_name", "interpret", "cross_fit",
    ),
)
def _simulate_merton_american_rows_pallas_f32(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    put: bool,
    basis_degree: int,
    exercise_every: int,
    antithetic: bool = False,
    row_offset: jax.Array | int = 0,
    axis_name: str | None = None,
    cross_fit: bool = False,
    interpret: bool = False,
) -> jax.Array:
    from spectralmc_tpu.ops.american import check_monitor_grid

    check_monitor_grid(timesteps, exercise_every)
    kernel = functools.partial(
        _merton_monitor_block_kernel, timesteps=timesteps,
        exercise_every=exercise_every, antithetic=antithetic,
    )
    price_rows = _launch(
        kernel, contract_key, contract, rows=rows, cols=cols,
        row_offset=row_offset, interpret=interpret,
        monitors=timesteps // exercise_every,
    )
    return _encode_american_rows(
        price_rows, contract,
        timesteps=timesteps, exercise_every=exercise_every,
        put=put, basis_degree=basis_degree, axis_name=axis_name,
        cross_fit=cross_fit,
    )


def simulate_merton_american_underlier_rows_pallas(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    option: "object",
    basis_degree: int = 5,
    exercise_every: int = 1,
    row_offset: jax.Array | int = 0,
    antithetic_half: int | None = None,
    axis_name: str | None = None,
    cross_fit: bool = False,
    interpret: bool = False,
) -> jax.Array:
    """Merton American underliers via the fused monitor-row kernel; raises
    where the kernel cannot run."""
    from spectralmc_tpu.ops.greeks import OptionSide

    _check_american(
        "simulate_merton_american_underlier_rows_pallas", interpret=interpret,
        dtype=dtype, rows=rows, cols=cols, timesteps=timesteps,
        exercise_every=exercise_every,
    )
    return _simulate_merton_american_rows_pallas_f32(
        contract_key, contract, timesteps=timesteps, rows=rows, cols=cols,
        put=option == OptionSide.PUT, basis_degree=basis_degree,
        exercise_every=exercise_every, antithetic=antithetic_half is not None,
        row_offset=row_offset, axis_name=axis_name, cross_fit=cross_fit,
        interpret=interpret,
    )
