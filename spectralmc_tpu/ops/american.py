"""American/Bermudan option pricing via Longstaff–Schwartz (LSMC).

Extension beyond the reference (European-only payoffs). Early exercise on
the discrete timestep grid — a Bermudan that converges to the American price
as the grid refines — via the classic regression Monte-Carlo of
Longstaff & Schwartz (2001), restructured for XLA:

* the full ``[timesteps, paths]`` path matrix comes from the existing
  simulator (``ops/gbm.py::simulate_paths`` — same (key, timestep) stream);
* the backward induction is ONE ``lax.scan`` over reversed time carrying the
  pathwise discounted-cashflow vector;
* the in-the-money regression is weighted least squares by mask (no dynamic
  shapes): normal equations ``(Φᵀ W Φ) β = Φᵀ W y`` with a small k×k solve
  per exercise date (k = basis_degree+1) — static, tiny, fusable.

Oracles (``tests/test_american.py``):
* a Bermudan-aware CRR binomial tree (host numpy float64) with exercise
  restricted to the SAME monitor dates — sharp, unlike continuous-exercise
  formulas;
* r = 0 ⟹ American put ≡ European put, and q = 0 ⟹ American call ≡ European
  call (no early-exercise premium) — exact classical identities against the
  Black formula.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from spectralmc_tpu.ops.gbm import PathScheme
from spectralmc_tpu.ops.greeks import OptionSide


def _ridge_chol_solve(
    gram: list[list[jax.Array]], rhs: list[jax.Array], *, dtype: jnp.dtype
) -> list[jax.Array]:
    """Solve ``(G + λ diag) β = rhs`` for a tiny static-k SPD system by a
    fully UNROLLED Cholesky on scalars — pure arithmetic that XLA fuses into
    the surrounding date body. ``jnp.linalg.solve`` lowers to an LU custom
    call that cannot fuse and serializes every backward-induction date behind
    a dispatch round-trip; at k ≤ 9 the unrolled factorization is ~k³/3
    scalar FLOPs and free. λ is the RELATIVE Tikhonov ridge: scaled
    per-column by the Gram diagonal (see ``_lsmc_backward``'s conditioning
    notes). The inner pivot is clamped at 1e-30 so an empty ITM set (all-zero
    Gram) yields β = 0 instead of NaN — matching the degenerate behaviour of
    the previous LU path.

    RANK-REVEALING COLUMN DROP (round-5 robustness find, surfaced by
    a declining-path oracle of a fused backward since removed, and
    reproduced on the shared XLA backward — both failed identically). On an EXACTLY
    singular Gram — all ITM paths identical, the zero-variance collapse —
    the Schur-complement pivots beyond the first column are pure ridge:
    eliminating the rank-1 part leaves ``d_j ≈ 2·eps·a_jj`` exactly, and
    the f32 moment-summation noise (~eps relative after the cancelling
    subtraction) is the SAME size, so the computed pivot is an O(1) coin
    flip around the ridge scale. Forward/back substitution then divides
    rhs residuals that are pure noise by ``sqrt(eps)``-scale pivots twice,
    exploding β to ~1e8 — a nonsense continuation surface whose sign
    decides exercise (measured: the put collapse exercised at the FIRST
    ITM date, pricing 0.56 instead of 11.0). The Loewner bound
    ``Schur(G + eps·D) ⪰ Schur(eps·D) = eps·D₂₂`` (G ⪰ 0) says any
    honestly-computed pivot is ≥ ``eps·G_jj``; a pivot within a small
    multiple of that floor therefore carries NO data signal — the column
    is numerically dependent on its predecessors and the statistically
    correct estimator drops it (β_j = 0), exactly what a rank-revealing
    factorization does. ``drop_j = d < 8·eps·a_jj`` gates the column: its
    sub-diagonal couplings, z, and β are zeroed, so it also vanishes from
    every later Schur complement. For every non-degenerate solve
    (unexplained column variance ≫ 8e-6 of the diagonal) the gate is 1.0
    and ``1.0·x`` is bit-exact in IEEE, so production policies are
    unchanged. The 1e-30 clamp still guards the all-zero empty-ITM Gram
    (β = 0, as before), and the ``eps·a_jj`` floor keeps the kept-pivot
    sqrt well-scaled."""
    k = len(rhs)
    eps = jnp.asarray(1e-6, dtype)
    tiny = jnp.asarray(1e-30, dtype)
    a = [[gram[i][j] for j in range(k)] for i in range(k)]
    for i in range(k):
        a[i][i] = a[i][i] + eps * jnp.maximum(a[i][i], tiny)
    low: list[list[jax.Array]] = [[a[0][0]] * k for _ in range(k)]  # overwritten
    keep: list[jax.Array] = [jnp.asarray(1.0, dtype)] * k
    for j in range(k):
        d = a[j][j] - sum(low[j][m] * low[j][m] for m in range(j))
        keep[j] = (d >= 8.0 * eps * a[j][j]).astype(dtype)
        low[j][j] = jnp.sqrt(jnp.maximum(jnp.maximum(d, eps * a[j][j]), tiny))
        for i in range(j + 1, k):
            s = a[i][j] - sum(low[i][m] * low[j][m] for m in range(j))
            low[i][j] = keep[j] * (s / low[j][j])
    z: list[jax.Array] = list(rhs)
    for i in range(k):
        z[i] = keep[i] * ((rhs[i] - sum(low[i][m] * z[m] for m in range(i))) / low[i][i])
    beta: list[jax.Array] = list(z)
    for i in reversed(range(k)):
        beta[i] = keep[i] * (
            (z[i] - sum(low[m][i] * beta[m] for m in range(i + 1, k))) / low[i][i]
        )
    return beta


def _lsmc_backward(
    price_rows: jax.Array,  # [monitor dates, ...path dims...] prices
    *,
    strike: jax.Array,
    disc: jax.Array,  # one-monitor-step discount
    dtype: jnp.dtype,
    put: bool,
    basis_degree: int,
    axis_name: str | None = None,
    extra_rows: jax.Array | None = None,  # [monitor dates, ...] per-date state
    disc_to_prev: jax.Array | None = None,  # [monitor dates] per-segment df
    rows_in_log_space: bool = False,
    fit_mask: jax.Array | None = None,  # [...path dims...] 1.0 = regression half
    cross_fit_mask: jax.Array | None = None,  # [...] 1.0 = half A (2-fold CV)
) -> jax.Array:
    """Longstaff–Schwartz backward induction → cashflows discounted to t=0.

    ``fit_mask`` (split-sample estimator): when given, the per-date
    regression moments are restricted to the mask's paths — the continuation
    surface is fitted on the fit half only, and the resulting exercise policy
    is applied to EVERY path. For fit-half paths this is exactly the classic
    single-sample recursion run on that half alone (their moments involve
    only their own cashflows); for the complement the policy is evaluated
    OUT-OF-SAMPLE, which removes Longstaff–Schwartz look-ahead bias: a
    suboptimal-but-independent policy makes the complement's mean cashflow a
    true lower bound on the Bermudan price in expectation, while the fit
    half's mean keeps the classic high-biased estimate — together they
    bracket the price (docs/performance.md, American quality decomposition;
    the reference has no early-exercise support at all). β is invariant to
    the moment normalization (gram and rhs scale together and the Tikhonov
    ridge is relative), so the mask needs no 2× renormalization.

    ``cross_fit_mask`` (bracket-midpoint cross-fitted estimator, round 5):
    the date body carries TWO cashflow recursions and emits their per-path
    midpoint. Leg 1 is the classic in-sample recursion (β fitted on all
    paths; HIGH-biased by Longstaff–Schwartz look-ahead). Leg 2 is 2-fold
    cross-fitted: β fitted per mask half, every path exercised against the
    OPPOSITE half's surface, so its cashflows are fully out-of-sample
    (LOW-biased by the policy suboptimality of a half-sample fit). The two
    biases are the two legs of the classic LSMC bracket; their midpoint
    cancels most of both. At the 8,192-path quality budget
    (benchmarks/american_quality_lab.py, 64 contracts × 16 reps) the
    midpoint sat between the in-sample and out-of-sample legs — pure 2-fold
    cross-fit was tried first and REJECTED: half-sample policy
    suboptimality is first-order in regression noise too, and at this
    budget it exceeds the look-ahead bias it removes. Cost over the classic
    pass: one extra rhs projection set in the same fused moment reduction
    (gram_full = gram_A + gram_B is additive — not recomputed), two more
    tiny k×k solves, and the second cashflow vector's traffic; the dominant
    row reads are shared. Mutually exclusive with ``fit_mask``. Mask
    discipline: callers split on COLUMN parity (``cross_fit_col_mask``) —
    columns are never mesh-sharded (the paths axis shards rows) and
    antithetic pairing mirrors whole rows, so both members of a mirrored
    pair land in the same half and the two halves stay independent under
    every topology.

    ``disc_to_prev`` (term structures): per-monitor-date discounts —
    ``disc_to_prev[i]`` is the discount over the segment ENDING at monitor
    date i (``disc_to_prev[0]`` covers t=0 → t_1), replacing the flat
    scalar ``disc`` in both the continuation valuation and the final
    discount to t=0. ``None`` keeps the flat path byte-identical.

    ONE ``lax.scan`` over reversed time carrying the pathwise cashflow vector.
    The in-the-money regression solves ridge-stabilized normal equations
    ``(ΦᵀWΦ/N + λI) β = ΦᵀWy/N``. Because every basis column is a monomial
    x^a·v^b, the Gram/rhs entries are MOMENTS ``Σ w·x^a·v^b`` — computed here
    as one fused multi-output reduction over the paths, so no ``[paths, k]``
    basis matrix is ever materialized (the round-3 implementation built Φ
    twice per date plus an LU custom call; that was ~93% of American pricing
    runtime — see docs/performance.md). Per date the only HBM traffic left is
    the price row and the cashflow vector, twice (moment pass + policy pass).
    The moment vector is additive over paths, so under a mesh ``paths`` axis
    it is ``psum``-reduced (``axis_name``) before the tiny k×k solve: every
    shard solves the identical system and the sharded policy equals the
    unsharded one up to reduction order (the same contract as the sharded
    spectrum, parallel/trainer.py docstring).

    Basis: powers of (S/K − 1). Centered moneyness keeps the Gram matrix
    well-conditioned in float32 (ITM region maps into (−1, 1)-ish), unlike
    raw m^j whose degree-10+ cross moments overflow the mantissa. With
    ``extra_rows`` (the Heston instantaneous variance, or the arithmetic
    basket's log dispersion ln(B_arith/B_geom)) the basis is augmented with
    [v, v·x, v²] — the standard second-state-variable LSMC regressors: the
    continuation value depends on BOTH state variables.

    ``rows_in_log_space``: ``price_rows`` holds LOG prices, exponentiated
    per date inside the scan body — the XLA engines hand their scan-stacked
    log matrix straight in, skipping a full-matrix exp round trip through
    HBM (exp is cheap VPU work recomputed per pass; the matrix is not).
    """
    if fit_mask is not None and cross_fit_mask is not None:
        raise ValueError("fit_mask and cross_fit_mask are mutually exclusive")
    base_k = basis_degree + 1
    has_extra = extra_rows is not None
    k = base_k + (3 if has_extra else 0)
    n = price_rows.shape[0]

    # Static column catalogue: column c = x^a · v^b with exponents (a, b).
    # Centered moneyness RESCALED to O(1): |S/K - 1| is ~0.1 on typical
    # domains, so raw powers decay 10^-j and the degree-5 Gram is
    # f32-singular up to reduction-order noise — under a mesh, psum'd
    # moments then yield visibly different policies per topology. The
    # x -> 5x column scaling spans the SAME polynomial space (beta
    # absorbs it exactly) but keeps all moments O(1), so the solve is
    # well-conditioned and shard-stable, and the ridge shrinks every
    # degree proportionally. The variance/dispersion state is ~0.05: same
    # O(1) rescaling (×20) for the augmented columns.
    col_exp: list[tuple[int, int]] = [(j, 0) for j in range(base_k)]
    if has_extra:
        col_exp += [(0, 1), (1, 1), (0, 2)]
    prod_exp = sorted(
        {
            (col_exp[i][0] + col_exp[j][0], col_exp[i][1] + col_exp[j][1])
            for i in range(k)
            for j in range(i, k)
        }
    )
    prod_idx = {p: i for i, p in enumerate(prod_exp)}
    max_a = max(a for a, _ in prod_exp)
    max_b = max(b for _, b in prod_exp)

    def immediate(s: jax.Array) -> jax.Array:
        return jnp.maximum(strike - s, 0.0) if put else jnp.maximum(s - strike, 0.0)

    def to_price(row: jax.Array) -> jax.Array:
        return jnp.exp(row) if rows_in_log_space else row

    def powers(z: jax.Array, top: int) -> list[jax.Array]:
        out = [jnp.ones_like(z)]
        for _ in range(top):
            out.append(out[-1] * z)
        return out

    # local path count; the global count folds in the mesh axis size
    n_local = 1
    for d in price_rows.shape[1:]:
        n_local *= d
    inv_n = jnp.asarray(1.0 / n_local, dtype)
    if axis_name is not None:
        inv_n = inv_n / jax.lax.psum(jnp.asarray(1.0, dtype), axis_name)

    cf_terminal = immediate(to_price(price_rows[n - 1]))

    def date_basis(
        row_t: jax.Array, extra: jax.Array | None
    ) -> tuple[jax.Array, jax.Array, list[jax.Array], list[jax.Array]]:
        s_t = to_price(row_t)
        exercise_now = immediate(s_t)
        x = (s_t / strike - 1.0) * 5.0
        xp = powers(x, max_a)
        vp = powers(extra * 20.0, max_b) if extra is not None else [jnp.ones_like(x)]
        return s_t, exercise_now, xp, vp

    def gram_from(moments: jax.Array, base: int) -> list[list[jax.Array]]:
        return [
            [
                moments[
                    base
                    + prod_idx[
                        (col_exp[i][0] + col_exp[j][0], col_exp[i][1] + col_exp[j][1])
                    ]
                ]
                for j in range(k)
            ]
            for i in range(k)
        ]

    def backward(
        cf_next: jax.Array,
        per_date: tuple[jax.Array, jax.Array | None, jax.Array],
    ) -> tuple[jax.Array, None]:
        row_t, extra, disc_step = per_date
        _, exercise_now, xp, vp = date_basis(row_t, extra)
        itm = (exercise_now > 0.0).astype(dtype)
        y = disc_step * cf_next  # continuation cashflow valued at THIS date
        w = itm if fit_mask is None else itm * fit_mask
        wy = w * y
        # ONE fused pass over the paths: all Gram moments + rhs projections
        # as sibling reductions sharing the same elementwise inputs.
        moments = (
            jnp.stack(
                [jnp.sum(w * xp[a] * vp[b]) for a, b in prod_exp]
                + [jnp.sum(wy * xp[a] * vp[b]) for a, b in col_exp]
            )
            * inv_n
        )
        if axis_name is not None:
            moments = jax.lax.psum(moments, axis_name)
        beta = _ridge_chol_solve(
            gram_from(moments, 0),
            [moments[len(prod_exp) + j] for j in range(k)],
            dtype=dtype,
        )
        continuation = sum(beta[j] * xp[a] * vp[b] for j, (a, b) in enumerate(col_exp))
        take = (itm > 0.0) & (exercise_now > continuation)
        return jnp.where(take, exercise_now, y), None

    def backward_xfit(
        cf_next: tuple[jax.Array, jax.Array],
        per_date: tuple[jax.Array, jax.Array | None, jax.Array],
    ) -> tuple[tuple[jax.Array, jax.Array], None]:
        # The midpoint-pair recursion: carry the classic IN-SAMPLE cashflow
        # (beta fitted on all paths — its own recursion, high-biased by
        # look-ahead) and the 2-fold OUT-OF-SAMPLE cashflow (beta fitted per
        # column-parity half, each path exercised against the opposite
        # half's surface — low-biased by half-sample policy suboptimality)
        # side by side through one date body. The Gram moments are shared
        # (gram_full = gram_A + gram_B, additive in exact arithmetic), so
        # the extra cost over the classic pass is one more rhs projection
        # set, two more tiny k×k solves and the second cashflow vector's
        # traffic — the row reads, the dominant term, are not repeated.
        row_t, extra, disc_step = per_date
        cf_ins_next, cf_oos_next = cf_next
        _, exercise_now, xp, vp = date_basis(row_t, extra)
        itm = (exercise_now > 0.0).astype(dtype)
        y_ins = disc_step * cf_ins_next
        y_oos = disc_step * cf_oos_next
        w_a = itm * cross_fit_mask
        w_b = itm - w_a  # itm * (1 - mask), same dtype arithmetic
        wy_a = w_a * y_oos
        wy_b = w_b * y_oos
        wy_full = itm * y_ins
        p_len = len(prod_exp)
        moments = (
            jnp.stack(
                [jnp.sum(w_a * xp[a] * vp[b]) for a, b in prod_exp]
                + [jnp.sum(w_b * xp[a] * vp[b]) for a, b in prod_exp]
                + [jnp.sum(wy_a * xp[a] * vp[b]) for a, b in col_exp]
                + [jnp.sum(wy_b * xp[a] * vp[b]) for a, b in col_exp]
                + [jnp.sum(wy_full * xp[a] * vp[b]) for a, b in col_exp]
            )
            * inv_n
        )
        if axis_name is not None:
            moments = jax.lax.psum(moments, axis_name)
        gram_a = gram_from(moments, 0)
        gram_b = gram_from(moments, p_len)
        gram_full = [
            [gram_a[i][j] + gram_b[i][j] for j in range(k)] for i in range(k)
        ]
        rhs_a = [moments[2 * p_len + j] for j in range(k)]
        rhs_b = [moments[2 * p_len + k + j] for j in range(k)]
        rhs_full = [moments[2 * p_len + 2 * k + j] for j in range(k)]
        beta_a = _ridge_chol_solve(gram_a, rhs_a, dtype=dtype)
        beta_b = _ridge_chol_solve(gram_b, rhs_b, dtype=dtype)
        beta_full = _ridge_chol_solve(gram_full, rhs_full, dtype=dtype)
        in_a = cross_fit_mask > 0.0
        cont_ins = sum(
            beta_full[j] * xp[a] * vp[b] for j, (a, b) in enumerate(col_exp)
        )
        cont_oos = sum(
            jnp.where(in_a, beta_b[j], beta_a[j]) * xp[a] * vp[b]
            for j, (a, b) in enumerate(col_exp)
        )
        cf_ins = jnp.where(
            (itm > 0.0) & (exercise_now > cont_ins), exercise_now, y_ins
        )
        cf_oos = jnp.where(
            (itm > 0.0) & (exercise_now > cont_oos), exercise_now, y_oos
        )
        return (cf_ins, cf_oos), None

    # walk t_{N-1} .. t_1 (rows n-2 .. 0); backward at row i consumes the
    # discount over the segment ENDING at row i+1
    if disc_to_prev is None:
        disc_rev = jnp.broadcast_to(jnp.asarray(disc, dtype), (n - 1,))
        disc_final = disc
    else:
        disc_rev = disc_to_prev[1:][::-1]
        disc_final = disc_to_prev[0]
    body = backward if cross_fit_mask is None else backward_xfit
    init = (
        cf_terminal
        if cross_fit_mask is None
        else (cf_terminal, cf_terminal)
    )
    if extra_rows is None:
        def body_no_extra(
            carry: jax.Array | tuple[jax.Array, jax.Array],
            per_date: tuple[jax.Array, jax.Array],
        ) -> tuple[jax.Array | tuple[jax.Array, jax.Array], None]:
            s_t, disc_step = per_date
            return body(carry, (s_t, None, disc_step))

        cf_1, _ = jax.lax.scan(
            body_no_extra, init, (price_rows[: n - 1][::-1], disc_rev)
        )
    else:
        cf_1, _ = jax.lax.scan(
            body,
            init,
            (price_rows[: n - 1][::-1], extra_rows[: n - 1][::-1], disc_rev),
        )
    if cross_fit_mask is not None:
        # bracket midpoint: the average of the high-biased in-sample leg and
        # the low-biased out-of-sample leg (see the cross_fit_mask notes)
        cf_1 = 0.5 * (cf_1[0] + cf_1[1])
    return disc_final * cf_1  # discounted to t = 0


def check_monitor_grid(timesteps: int, exercise_every: int) -> None:
    """Trace-time guards on the static monitor grid: ``exercise_every`` must
    divide ``timesteps`` (else maturity silently drops off the monitor set)
    and the grid must keep >= 2 monitor dates (1 date IS the European option
    — the same contract build_simulation_params and the effect route
    enforce). Shared by the XLA encode and the Pallas monitor-row engine
    (``ops/gbm_pallas.py``) so both reject the same grids."""
    if exercise_every < 1 or timesteps % exercise_every:
        raise ValueError(
            f"exercise_every={exercise_every} must divide timesteps={timesteps}"
        )
    if timesteps // exercise_every < 2:
        raise ValueError(
            f"early exercise needs >= 2 monitor dates; timesteps={timesteps} "
            f"with exercise_every={exercise_every} leaves "
            f"{timesteps // exercise_every}"
        )


def encode_monitor_prices(
    price_rows: jax.Array,  # [monitor dates, ...path dims...] PRICE space
    *,
    strike: jax.Array,
    maturity: jax.Array,
    rate: jax.Array,
    disc_monitor: jax.Array,  # one-MONITOR-step discount e^{-r*dt*every}
    dtype: jnp.dtype,
    put: bool,
    basis_degree: int,
    axis_name: str | None = None,
    extra_rows: jax.Array | None = None,
    disc_to_prev: jax.Array | None = None,  # term curves: per-segment dfs
    df_total: jax.Array | None = None,  # term curves: curve df(0, T)
    rows_in_log_space: bool = False,
    cross_fit: bool = False,
) -> jax.Array:
    """Backward induction + synthetic-underlier encode from MONITOR-date
    price rows. The Bermudan cashflow cf (discounted to t=0) is re-encoded
    as ``u = strike − cf/df`` so the framework's put-payoff pipeline
    ``df·max(strike − u, 0)`` reproduces cf exactly for both option sides
    (``PayoffKind`` docstring in ops/gbm.py). Split out of
    ``_american_encode`` so the Pallas engine — whose fused forward kernel
    emits monitor-date prices directly — runs the IDENTICAL estimator.
    ``rows_in_log_space``: the rows are LOG prices, exponentiated per date
    inside the induction (the XLA engines' path; see ``_lsmc_backward``).
    ``cross_fit``: 2-fold out-of-sample exercise policy split on column
    parity (``_lsmc_backward``'s ``cross_fit_mask`` notes)."""
    cf = _lsmc_backward(
        price_rows,
        strike=strike,
        disc=disc_monitor,
        dtype=dtype,
        put=put,
        basis_degree=basis_degree,
        axis_name=axis_name,
        extra_rows=extra_rows,
        disc_to_prev=disc_to_prev,
        rows_in_log_space=rows_in_log_space,
        cross_fit_mask=(
            cross_fit_col_mask(price_rows.shape[-1], dtype=dtype) if cross_fit else None
        ),
    )
    df = jnp.exp(-rate * maturity) if df_total is None else df_total
    return strike - cf / df


def _american_encode(
    log_rows: jax.Array,
    *,
    timesteps: int,
    exercise_every: int,
    strike: jax.Array,
    maturity: jax.Array,
    rate: jax.Array,
    dt: jax.Array,
    dtype: jnp.dtype,
    put: bool,
    basis_degree: int,
    axis_name: str | None,
    extra_rows: jax.Array | None = None,
    term: "object | None" = None,
    cross_fit: bool = False,
) -> jax.Array:
    """Monitor-grid slice + backward induction + synthetic-underlier encode —
    the ONE Bermudan tail every dynamics shares (a divergence here would let
    GBM and Heston silently disagree about monitor semantics).

    Slicing the stored rows and compounding the one-step discount is exact:
    dates between monitors carry no decision, only discounting. With a
    ``term`` structure (GBM only) the per-monitor-segment discounts follow
    the rate curve and the encode df is the curve-effective
    ``exp(−r·mean(rs)·T)`` — the SAME df ``terminal_to_prices`` divides out,
    so the round trip still reproduces cf exactly.
    """
    check_monitor_grid(timesteps, exercise_every)
    log_price_rows = log_rows[exercise_every - 1 :: exercise_every]
    monitor_extra = (
        None if extra_rows is None else extra_rows[exercise_every - 1 :: exercise_every]
    )
    disc_to_prev = None
    df_total = None
    if term is not None:
        _, rs, _ = term.shapes(timesteps)
        rate_dt = rate * jnp.asarray(rs, dtype) * dt  # [T] per-step r_t dt
        seg = rate_dt.reshape(timesteps // exercise_every, exercise_every).sum(axis=1)
        disc_to_prev = jnp.exp(-seg)  # [n_monitor] segment discounts
        mr = sum(rs) / timesteps
        df_total = jnp.exp(-rate * jnp.asarray(mr, dtype) * maturity)
    return encode_monitor_prices(
        log_price_rows,
        strike=strike,
        maturity=maturity,
        rate=rate,
        disc_monitor=jnp.exp(-rate * dt * exercise_every),
        dtype=dtype,
        put=put,
        basis_degree=basis_degree,
        axis_name=axis_name,
        extra_rows=monitor_extra,
        disc_to_prev=disc_to_prev,
        df_total=df_total,
        rows_in_log_space=True,
        cross_fit=cross_fit,
    )


@partial(
    jax.jit,
    static_argnames=(
        "timesteps",
        "rows",
        "cols",
        "dtype",
        "option",
        "basis_degree",
        "exercise_every",
        "antithetic_half",
        "axis_name",
        "term",
        "cross_fit",
    ),
)
def simulate_american_underlier_rows(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    option: OptionSide,
    basis_degree: int = 5,
    exercise_every: int = 1,
    row_offset: jax.Array | int = 0,
    antithetic_half: int | None = None,
    axis_name: str | None = None,
    term: "object | None" = None,
    cross_fit: bool = False,
) -> jax.Array:
    """``[rows, cols]`` SYNTHETIC underliers for the AMERICAN payoff kinds.

    The per-path Bermudan cashflow cf (discounted to t=0, exercise on the
    timestep grid) is re-encoded as ``u = strike − cf/df`` so the framework's
    put-payoff pipeline ``df·max(strike − u, 0)`` reproduces cf exactly for
    both option sides (``PayoffKind`` docstring in ops/gbm.py) — the
    spectrum/train/predict machinery runs unchanged.

    Stream discipline: normals are keyed by (contract_key, global row,
    timestep) exactly like ``gbm.simulate_terminal_rows`` — ``row_offset``
    makes a mesh shard reproduce its global rows bit-for-bit. The regression,
    which couples ALL paths, stays shard-consistent by ``psum``-ing its
    moment sums over ``axis_name`` (see ``_lsmc_backward``).
    """
    from spectralmc_tpu.ops.gbm import _row_streams, _step_coeffs

    if term is not None and term.is_flat():
        term = None  # flat curves are the flat program, bit-identically
    spot, strike, maturity, rate, _, vol = (contract[i].astype(dtype) for i in range(6))
    div_yield = contract[4].astype(dtype)
    dt = maturity / jnp.asarray(timesteps, dtype)
    sqrt_dt = jnp.sqrt(dt)
    log_drift, _, vol_step = _step_coeffs(
        term,
        timesteps=timesteps,
        dtype=dtype,
        rate=rate,
        div_yield=div_yield,
        vol=vol,
        dt=dt,
        sqrt_dt=sqrt_dt,
    )

    row_keys, sign = _row_streams(
        contract_key,
        rows=rows,
        row_offset=row_offset,
        antithetic_half=antithetic_half,
        dtype=dtype,
    )

    def normals(t: jax.Array) -> jax.Array:
        z = jax.vmap(
            lambda rk: jax.random.normal(jax.random.fold_in(rk, t), (cols,), dtype)
        )(row_keys)
        return z if sign is None else sign * z

    def fwd(logx: jax.Array, t: jax.Array) -> tuple[jax.Array, jax.Array]:
        nxt = logx + log_drift(t) + vol_step(t) * normals(t)
        return nxt, nxt

    log0 = jnp.full((rows, cols), 0.0, dtype) + jnp.log(spot)
    _, log_rows = jax.lax.scan(fwd, log0, jnp.arange(timesteps))

    return _american_encode(
        log_rows,
        timesteps=timesteps,
        exercise_every=exercise_every,
        strike=strike,
        maturity=maturity,
        rate=rate,
        dt=dt,
        dtype=dtype,
        put=option == OptionSide.PUT,
        basis_degree=basis_degree,
        axis_name=axis_name,
        term=term,
        cross_fit=cross_fit,
    )


def heston_state_rows(
    row_keys: jax.Array,
    sign: jax.Array | None,
    *,
    spot: jax.Array,
    v0: jax.Array,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    **step_consts: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """(log_rows, v_rows), each ``[timesteps, rows, cols]`` — the Heston
    state at every monitor date, drawn through the shared stream/step
    (``ops/heston.py``). Exposed so tests can pin the American forward pass
    bit-exactly against the European simulator's terminal values."""
    from spectralmc_tpu.ops.heston import heston_component_normals, heston_euler_step

    def fwd(
        carry: tuple[jax.Array, jax.Array], t: jax.Array
    ) -> tuple[tuple[jax.Array, jax.Array], tuple[jax.Array, jax.Array]]:
        logx, v = carry
        z_v = heston_component_normals(row_keys, sign, t, 0, cols, dtype)
        z_orth = heston_component_normals(row_keys, sign, t, 1, cols, dtype)
        logx, v = heston_euler_step(logx, v, z_v, z_orth, **step_consts)
        return (logx, v), (logx, v)

    log0 = jnp.full((rows, cols), 0.0, dtype) + jnp.log(spot)
    vinit = jnp.full((rows, cols), 1.0, dtype) * v0
    _, (log_rows, v_rows) = jax.lax.scan(fwd, (log0, vinit), jnp.arange(timesteps))
    return log_rows, v_rows


@partial(
    jax.jit,
    static_argnames=(
        "timesteps",
        "rows",
        "cols",
        "dtype",
        "option",
        "basis_degree",
        "exercise_every",
        "antithetic_half",
        "axis_name",
        "cross_fit",
    ),
)
def simulate_heston_american_underlier_rows(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    option: OptionSide,
    basis_degree: int = 5,
    exercise_every: int = 1,
    row_offset: jax.Array | int = 0,
    antithetic_half: int | None = None,
    axis_name: str | None = None,
    cross_fit: bool = False,
) -> jax.Array:
    """``[rows, cols]`` synthetic American underliers under HESTON dynamics.

    Same encoding and shard discipline as the GBM variant; ``contract`` is
    the 10-vector of ``HestonContract.as_array``. The forward pass replays
    ``ops/heston.py::simulate_heston_underlier_rows``'s exact stream —
    normals keyed (contract_key, global row, timestep, component), component
    0 driving the variance — storing BOTH state variables per exercise date;
    the regression basis adds [v, v·x, v²] (``_lsmc_backward``): under
    stochastic vol the continuation value depends on the variance too, and
    dropping it biases the policy (exercises too early in high-vol states).

    Oracle identities (no Heston Bermudan tree exists in closed form):
    q = 0 ⟹ American call ≡ European call (Merton — validated against the
    semi-analytic ``heston_call_price``); American ⩾ European pathwise.
    """
    from spectralmc_tpu.ops.gbm import _row_streams

    (spot, strike, maturity, rate, div_yield, v0, kappa, theta, xi, rho) = (
        contract[i].astype(dtype) for i in range(10)
    )
    dt = maturity / jnp.asarray(timesteps, dtype)
    sqrt_dt = jnp.sqrt(dt)
    rho_bar = jnp.sqrt(1.0 - rho * rho)

    row_keys, sign = _row_streams(
        contract_key,
        rows=rows,
        row_offset=row_offset,
        antithetic_half=antithetic_half,
        dtype=dtype,
    )
    log_rows, v_rows = heston_state_rows(
        row_keys,
        sign,
        spot=spot,
        v0=v0,
        timesteps=timesteps,
        rows=rows,
        cols=cols,
        dtype=dtype,
        rate=rate,
        div_yield=div_yield,
        dt=dt,
        sqrt_dt=sqrt_dt,
        rho=rho,
        rho_bar=rho_bar,
        kappa=kappa,
        theta=theta,
        xi=xi,
    )

    return _american_encode(
        log_rows,
        timesteps=timesteps,
        exercise_every=exercise_every,
        strike=strike,
        maturity=maturity,
        rate=rate,
        dt=dt,
        dtype=dtype,
        put=option == OptionSide.PUT,
        basis_degree=basis_degree,
        axis_name=axis_name,
        extra_rows=jnp.maximum(v_rows, 0.0),
        cross_fit=cross_fit,
    )


def merton_state_rows(
    row_keys: jax.Array,
    sign: jax.Array | None,
    *,
    spot: jax.Array,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    drift: jax.Array,
    vol_sqdt: jax.Array,
    lam_dt: jax.Array,
    jump_mean: jax.Array,
    jump_std: jax.Array,
) -> jax.Array:
    """``[timesteps, rows, cols]`` log-spot at every monitor date under
    MERTON dynamics, drawn through the shared stream helpers
    (``ops/merton.py::merton_component_normals`` / ``merton_jump_counts``) —
    exposed so tests can pin the American forward pass bit-exactly against
    the European simulator's terminal values (the heston_state_rows
    contract)."""
    from spectralmc_tpu.ops.merton import merton_component_normals, merton_jump_counts

    def fwd(logx: jax.Array, t: jax.Array) -> tuple[jax.Array, jax.Array]:
        z_d = merton_component_normals(row_keys, sign, t, 0, cols, dtype)
        z_j = merton_component_normals(row_keys, sign, t, 1, cols, dtype)
        counts = merton_jump_counts(row_keys, t, lam_dt, cols, dtype)
        jump = counts * jump_mean + jump_std * jnp.sqrt(counts) * z_j
        nxt = logx + drift + vol_sqdt * z_d + jump
        return nxt, nxt

    log0 = jnp.full((rows, cols), 0.0, dtype) + jnp.log(spot)
    _, log_rows = jax.lax.scan(fwd, log0, jnp.arange(timesteps))
    return log_rows


@partial(
    jax.jit,
    static_argnames=(
        "timesteps",
        "rows",
        "cols",
        "dtype",
        "option",
        "basis_degree",
        "exercise_every",
        "antithetic_half",
        "axis_name",
        "cross_fit",
    ),
)
def simulate_merton_american_underlier_rows(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    option: OptionSide,
    basis_degree: int = 5,
    exercise_every: int = 1,
    row_offset: jax.Array | int = 0,
    antithetic_half: int | None = None,
    axis_name: str | None = None,
    cross_fit: bool = False,
) -> jax.Array:
    """``[rows, cols]`` synthetic American underliers under MERTON dynamics.

    Same encoding and shard discipline as the GBM variant; ``contract`` is
    the 9-vector of ``MertonContract.as_array``. The forward pass replays
    ``ops/merton.py::simulate_merton_underlier_rows``'s exact stream —
    diffusion normal (component 0), jump-size normal (component 1), Poisson
    count (component 2). The spot alone is Markov (jumps are memoryless), so
    the plain moneyness basis applies unchanged — no state augmentation.

    Oracle identities (no jump Bermudan tree exists in closed form):
    r = 0 ⟹ American put ≡ European put and q = 0 ⟹ American call ≡
    European call (both model-independent martingale arguments — validated
    against the exact series ``merton_call_price``); American ⩾ European.
    """
    from spectralmc_tpu.ops.gbm import _row_streams

    (spot, strike, maturity, rate, div_yield, vol, lam, jump_mean, jump_std) = (
        contract[i].astype(dtype) for i in range(9)
    )
    dt = maturity / jnp.asarray(timesteps, dtype)
    m = jnp.exp(jump_mean + 0.5 * jump_std * jump_std) - 1.0

    row_keys, sign = _row_streams(
        contract_key,
        rows=rows,
        row_offset=row_offset,
        antithetic_half=antithetic_half,
        dtype=dtype,
    )
    log_rows = merton_state_rows(
        row_keys,
        sign,
        spot=spot,
        timesteps=timesteps,
        rows=rows,
        cols=cols,
        dtype=dtype,
        drift=(rate - div_yield - lam * m - 0.5 * vol * vol) * dt,
        vol_sqdt=vol * jnp.sqrt(dt),
        lam_dt=lam * dt,
        jump_mean=jump_mean,
        jump_std=jump_std,
    )

    return _american_encode(
        log_rows,
        timesteps=timesteps,
        exercise_every=exercise_every,
        strike=strike,
        maturity=maturity,
        rate=rate,
        dt=dt,
        dtype=dtype,
        put=option == OptionSide.PUT,
        basis_degree=basis_degree,
        axis_name=axis_name,
        cross_fit=cross_fit,
    )


def basket_state_rows(
    row_keys: jax.Array,
    sign: jax.Array | None,
    *,
    log_spots: jax.Array,  # [A] per-asset initial log-spot
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    drift: jax.Array,
    sig_sqdt: jax.Array,
    chol: jax.Array,
    weights: jax.Array,
    geometric: bool,
) -> tuple[jax.Array, jax.Array]:
    """(lb_rows, disp_rows), each ``[timesteps, rows, cols]`` — the log
    BASKET value (and, for arithmetic combines, the log arithmetic/geometric
    dispersion ln(B_arith/B_geom)) at every monitor date, drawn through the
    shared stream/step (``ops/basket.py::basket_component_normals`` /
    ``basket_euler_step``) — exposed so tests can pin the American forward
    pass bit-exactly against the European simulator's terminal values (the
    heston_state_rows contract). For geometric combines disp_rows is zeros
    (ln B IS Markov; no augmentation needed)."""
    from spectralmc_tpu.ops.basket import basket_component_normals, basket_euler_step

    a_n = log_spots.shape[0]

    def fwd(
        logx: jax.Array, t: jax.Array
    ) -> tuple[jax.Array, tuple[jax.Array, jax.Array]]:
        z = basket_component_normals(row_keys, sign, t, a_n, cols, dtype)
        nxt = basket_euler_step(logx, z, drift=drift, sig_sqdt=sig_sqdt, chol=chol)
        lg = jnp.einsum("a,arc->rc", weights, nxt)  # log geometric basket
        if geometric:
            return nxt, (lg, jnp.zeros_like(lg))
        lb = jnp.log(jnp.einsum("a,arc->rc", weights, jnp.exp(nxt)))
        return nxt, (lb, lb - lg)  # ln(B_arith/B_geom) >= 0 (Jensen)

    log0 = jnp.zeros((a_n, rows, cols), dtype) + log_spots[:, None, None]
    _, (lb_rows, disp_rows) = jax.lax.scan(fwd, log0, jnp.arange(timesteps))
    return lb_rows, disp_rows


@partial(
    jax.jit,
    static_argnames=(
        "spec",
        "timesteps",
        "rows",
        "cols",
        "dtype",
        "option",
        "basis_degree",
        "exercise_every",
        "antithetic_half",
        "axis_name",
        "cross_fit",
    ),
)
def simulate_basket_american_underlier_rows(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    spec: "object",
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    option: OptionSide,
    basis_degree: int = 5,
    exercise_every: int = 1,
    row_offset: jax.Array | int = 0,
    antithetic_half: int | None = None,
    axis_name: str | None = None,
    cross_fit: bool = False,
) -> jax.Array:
    """``[rows, cols]`` synthetic American underliers under BASKET dynamics.

    ``contract`` is the 6-vector of ``BlackScholesContract.as_array``;
    ``spec`` the static checkpointed ``BasketSpec``. The forward pass replays
    ``ops/basket.py::simulate_basket_underlier_rows``'s exact stream and step
    (``basket_component_normals`` / ``basket_euler_step``), storing the log
    BASKET value per date; exercise compares strike against the combined
    basket (the traded instrument).

    Regression state:
    * GEOMETRIC combine — ln B is itself an arithmetic Brownian motion
      (drift μ̄, variance s̄², ``basket_log_moments``), so B is Markov and
      the plain moneyness basis is the EXACT state. This also yields a
      sharp oracle: the geometric-basket Bermudan equals a single-asset GBM
      Bermudan at (G₀, σ_G = s̄, δ_eff = r − μ̄ − s̄²/2) — gated against
      ``bermudan_tree_price`` in tests/test_american.py.
    * ARITHMETIC combine — B alone is not Markov (the same basket value can
      hide different asset dispersions with different continuation values);
      the basis is augmented with the log arithmetic/geometric dispersion
      d = ln(B_arith/B_geom) ⩾ 0 (Jensen), the standard one-dimensional
      summary of cross-sectional spread, via ``_lsmc_backward``'s
      ``extra_rows`` columns [d, d·x, d²]. Gates: r = 0 put / q = 0 call
      no-early-exercise identities vs the same-stream European MC.
    """
    from spectralmc_tpu.ops.basket import BasketCombine, basket_cholesky
    from spectralmc_tpu.ops.gbm import _row_streams

    spot, strike, maturity, rate, div_yield, vol = (
        contract[i].astype(dtype) for i in range(6)
    )
    dt = maturity / jnp.asarray(timesteps, dtype)
    sigmas = vol * jnp.asarray(spec.vol_multipliers, dtype)
    geometric = spec.combine == BasketCombine.GEOMETRIC

    row_keys, sign = _row_streams(
        contract_key,
        rows=rows,
        row_offset=row_offset,
        antithetic_half=antithetic_half,
        dtype=dtype,
    )
    lb_rows, disp_rows = basket_state_rows(
        row_keys,
        sign,
        log_spots=jnp.log(spot * jnp.asarray(spec.spot_multipliers, dtype)),
        timesteps=timesteps,
        rows=rows,
        cols=cols,
        dtype=dtype,
        drift=(rate - div_yield - 0.5 * sigmas * sigmas) * dt,
        sig_sqdt=sigmas * jnp.sqrt(dt),
        chol=jnp.asarray(basket_cholesky(spec), dtype),
        weights=jnp.asarray(spec.weights, dtype),
        geometric=geometric,
    )

    return _american_encode(
        lb_rows,
        timesteps=timesteps,
        exercise_every=exercise_every,
        strike=strike,
        maturity=maturity,
        rate=rate,
        dt=dt,
        dtype=dtype,
        put=option == OptionSide.PUT,
        basis_degree=basis_degree,
        axis_name=axis_name,
        extra_rows=None if geometric else disp_rows,
        cross_fit=cross_fit,
    )


@partial(
    jax.jit,
    static_argnames=(
        "timesteps",
        "paths",
        "dtype",
        "option",
        "basis_degree",
        "split_sample",
        "cross_fit",
    ),
)
def lsmc_cashflows(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    paths: int,
    dtype: jnp.dtype,
    option: OptionSide = OptionSide.PUT,
    basis_degree: int = 5,
    split_sample: bool = False,
    cross_fit: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """(discounted Bermudan cashflows, terminal values), both ``[paths]``.

    The terminal row rides along so callers can price the same-path European
    control leg without re-simulating the whole path matrix (it is the
    dominant cost at production path counts).

    ``split_sample``: fit the continuation regressions on the EVEN-index
    paths only (``split_fit_mask``) and apply the policy to every path —
    even-path cashflows carry the classic in-sample (look-ahead, high-biased)
    estimate, odd-path cashflows the out-of-sample lower bound
    (``_lsmc_backward``'s ``fit_mask`` notes). Interleaving keeps both halves
    statistically identical; the paths here carry no antithetic pairing, so
    the halves are independent as the estimator requires.

    ``cross_fit``: the bracket-midpoint cross-fitted estimator — each path's
    cashflow is the average of the classic in-sample recursion (high-biased)
    and the 2-fold out-of-sample recursion (low-biased), cancelling most of
    both biases at full path count (``_lsmc_backward``'s ``cross_fit_mask``
    notes; the split here is path-index parity, the flat analogue of the
    simulators' column parity). Mutually exclusive with ``split_sample``.

    Exercise opportunities at every grid date t_1..t_N (t_N = maturity).
    The regression estimates continuation value on in-the-money paths with a
    polynomial basis in moneyness S/K; exercise wherever immediate payoff
    beats the estimate. Cashflows are discounted to t = 0. Default basis
    degree 5: measured at 1M paths x 16 dates vs the Bermudan tree, degree 3
    prices ~1.0% low (policy bias) and degree 5 ~0.1% low (degree 7 adds
    nothing). Throughput: bench.py american_lsmc_path_steps_per_sec.
    """
    from spectralmc_tpu.ops.gbm import simulate_paths

    _, strike, maturity, rate, _, _ = (contract[i].astype(dtype) for i in range(6))
    n = timesteps
    dt = maturity / jnp.asarray(n, dtype)
    disc = jnp.exp(-rate * dt)  # one-step discount

    # [timesteps, paths]: row t is the state at t_{t+1}
    s = simulate_paths(
        contract_key,
        contract,
        timesteps=n,
        paths=paths,
        dtype=dtype,
        scheme=PathScheme.LOG_EULER,
        normalize=False,
    )
    # ONE backward-induction implementation for every LSMC entry point
    # (_lsmc_backward): centered-moneyness basis, 1/N-normalized moments,
    # relative Tikhonov ridge — so the oracle calibration of this function
    # and the family simulators' policy are the same estimator. The path
    # matrix is already in price space; no log/exp round trip.
    cf = _lsmc_backward(
        s,
        strike=strike,
        disc=disc,
        dtype=dtype,
        put=option == OptionSide.PUT,
        basis_degree=basis_degree,
        fit_mask=split_fit_mask(paths, dtype=dtype) if split_sample else None,
        cross_fit_mask=cross_fit_col_mask(paths, dtype=dtype) if cross_fit else None,
    )
    return cf, s[n - 1]  # cashflows discounted to t = 0


def split_fit_mask(paths: int, *, dtype: jnp.dtype) -> jax.Array:
    """The split-sample estimator's fit-half selector: 1.0 on even path
    indices, 0.0 on odd. One definition shared by the cashflow producers and
    the consumers that slice the two estimates back apart (``lsmc_price``)."""
    return (jnp.arange(paths) % 2 == 0).astype(dtype)


def cross_fit_col_mask(cols: int, *, dtype: jnp.dtype) -> jax.Array:
    """The cross-fitted estimator's half-A selector: 1.0 on even COLUMN
    indices of the ``[rows, cols]`` path matrix (broadcasts over rows).

    Column parity is the one split that is simultaneously (a) shard-stable —
    the mesh ``paths`` axis shards ROWS, every shard holds all columns, so no
    ``row_offset`` enters; (b) antithetic-safe — pairing mirrors whole rows
    (``gbm._row_streams``; the Pallas kernels mirror row halves in-block), so
    a mirrored pair shares its column and lands in one half; and (c)
    independent across halves — within a row, columns are distinct draws of
    the per-(key, timestep) normal vector. One definition shared by every
    American simulator (XLA and Pallas encode tails)."""
    return (jnp.arange(cols) % 2 == 0).astype(dtype)


@dataclass(frozen=True)
class AmericanPrice:
    price: float
    std_error: float
    european: float  # same-path European price (control/lower bound)
    # control-variate estimate: price - beta*(european_mc - european_black),
    # beta = cov(cf, euro)/var(euro) from the sample. The European leg shares
    # every path with the Bermudan cashflow, so the common MC noise cancels —
    # measured ~1.5-2x std-error reduction at the test workloads (the
    # correlation is imperfect: exercised paths stop tracking the terminal
    # payoff) — a free accuracy knob on top of antithetic pairing.
    cv_price: float = float("nan")
    cv_std_error: float = float("nan")
    # split-sample estimator (lsmc_price(split_sample=True)): price/std_error/
    # cv_* are then the OUT-OF-SAMPLE half (a statistical lower bound — the
    # policy was fitted on the other half), and in_sample_price records the
    # fit half's classic look-ahead (high-biased) mean. The pair brackets the
    # true Bermudan price; their gap is a direct read of the LSMC policy bias
    # at this path budget (docs/performance.md quality decomposition).
    in_sample_price: float = float("nan")


def lsmc_price(
    sim_key: jax.Array,
    contract: "object",
    *,
    timesteps: int,
    paths: int,
    option: OptionSide = OptionSide.PUT,
    basis_degree: int = 5,
    dtype: jnp.dtype = jnp.float32,
    split_sample: bool = False,
    cross_fit: bool = False,
) -> AmericanPrice:
    """Host-facing Bermudan price with standard error + same-path European.

    ``contract`` is a ``BlackScholesContract``; the European leg reuses the
    identical paths (discounted terminal exercise only), so
    ``price >= european`` holds pathwise-statistically and the early-exercise
    premium is a low-variance difference.

    ``split_sample=True`` prices with the out-of-sample estimator: the
    continuation surface is fitted on the even-index half of the paths and
    the resulting policy is evaluated on the odd half, whose mean is a true
    lower bound in expectation (no look-ahead). The returned ``price``/
    ``std_error``/``cv_*`` are the out-of-sample half's (the standard error
    reflects the halved sample); ``in_sample_price`` keeps the fit half's
    classic high-biased estimate so the two bracket the Bermudan price.

    ``cross_fit=True`` prices with the bracket-midpoint cross-fitted
    estimator: each path's cashflow averages the in-sample and out-of-sample
    recursions, cancelling most of the look-ahead and policy-suboptimality
    biases over ALL paths at full standard error — the training-target
    estimator (``SimulationParams.lsmc_cross_fit``) in host-pricing form.
    """
    arr = contract.as_array(dtype)
    cf, terminal = lsmc_cashflows(
        sim_key,
        arr,
        timesteps=timesteps,
        paths=paths,
        dtype=dtype,
        option=option,
        basis_degree=basis_degree,
        split_sample=split_sample,
        cross_fit=cross_fit,
    )
    in_sample = float("nan")
    if split_sample:
        in_sample = float(jnp.mean(cf[0::2]))
        cf, terminal = cf[1::2], terminal[1::2]
    strike, maturity, rate = (arr[i].astype(dtype) for i in (1, 2, 3))
    df = jnp.exp(-rate * maturity)
    if option == OptionSide.PUT:
        euro = df * jnp.maximum(strike - terminal, 0.0)
    else:
        euro = df * jnp.maximum(terminal - strike, 0.0)
    # control variate: the European leg's exact mean is the Black price, so
    # cv_i = cf_i - beta*(euro_i - E_black[euro]) is unbiased (up to the
    # O(1/n) sample-beta term) with var reduced by the squared correlation
    from spectralmc_tpu.ops.analytic import black_scholes_price

    prices = black_scholes_price(
        contract.spot, contract.strike, contract.maturity, contract.rate,
        contract.div_yield, contract.vol,
    )
    euro_exact = jnp.asarray(
        prices.put if option == OptionSide.PUT else prices.call, dtype
    )
    euro_centered = euro - jnp.mean(euro)
    var_euro = jnp.mean(euro_centered * euro_centered)
    beta = jnp.where(
        var_euro > 0.0,
        jnp.mean((cf - jnp.mean(cf)) * euro_centered) / jnp.maximum(var_euro, 1e-30),
        0.0,
    )
    cv = cf - beta * (euro - euro_exact)
    return AmericanPrice(
        price=float(jnp.mean(cf)),
        std_error=float(jnp.std(cf)) / float(np.sqrt(cf.size)),
        european=float(jnp.mean(euro)),
        cv_price=float(jnp.mean(cv)),
        cv_std_error=float(jnp.std(cv)) / float(np.sqrt(cf.size)),
        in_sample_price=in_sample,
    )


def bermudan_tree_price(
    *,
    spot: float,
    strike: float,
    maturity: float,
    rate: float,
    div_yield: float,
    vol: float,
    exercise_dates: int,
    tree_steps: int = 4000,
    option: str = "put",
) -> float:
    """CRR binomial Bermudan oracle (host numpy float64).

    Exercise allowed ONLY at the ``exercise_dates`` grid layers
    t_i = i·T/exercise_dates (plus maturity) — matching the LSMC monitor
    grid exactly, so the comparison carries no continuous-exercise bias.
    ``tree_steps`` is rounded up to a multiple of ``exercise_dates``.
    """
    per = -(-tree_steps // exercise_dates)
    n = per * exercise_dates
    dt = maturity / n
    u = float(np.exp(vol * np.sqrt(dt)))
    d = 1.0 / u
    growth = float(np.exp((rate - div_yield) * dt))
    p = (growth - d) / (u - d)
    if not 0.0 < p < 1.0:
        raise ValueError(f"CRR probability out of range: {p}")
    disc = float(np.exp(-rate * dt))

    j = np.arange(n + 1, dtype=np.float64)
    s_t = spot * u ** (n - j) * d**j

    def payoff(x: np.ndarray) -> np.ndarray:
        return np.maximum(strike - x, 0.0) if option == "put" else np.maximum(x - strike, 0.0)

    value = payoff(s_t)
    for step in range(n - 1, -1, -1):
        value = disc * (p * value[:-1] + (1.0 - p) * value[1:])
        if step % per == 0 and step > 0:  # a monitor date layer
            j = np.arange(step + 1, dtype=np.float64)
            s_t = spot * u ** (step - j) * d**j
            value = np.maximum(value, payoff(s_t))
    return float(value[0])


def bermudan_grid_price(
    *,
    spot: float,
    strike: float,
    maturity: float,
    rate: float,
    div_yield: float,
    vol: float,
    timesteps: int,
    exercise_every: int = 1,
    option: str = "put",
    vol_shape: tuple[float, ...] = (),
    rate_shape: tuple[float, ...] = (),
    div_shape: tuple[float, ...] = (),
    grid_points: int = 2049,
    width_std: float = 8.0,
) -> float:
    """Bermudan put/call by Gaussian-transition backward induction on a log
    grid (host numpy float64) — the lattice oracle that handles TERM
    STRUCTURES, which the CRR tree cannot (a recombining binomial lattice
    needs constant vol; piecewise vols break recombination).

    Exercise only on the simulator's monitor dates t_k = k·every·dt with
    continuation expectations taken per STEP through the exact one-step
    Gaussian transition of the log-Euler discretization (the same
    construction as ``ops/analytic.py::discrete_barrier_price``) and the
    step's own curve rate for discounting. Exact for the discrete-grid
    Bermudan up to quadrature/truncation error (≪ the MC noise it gates);
    with flat shapes it cross-validates against ``bermudan_tree_price``
    (tests/test_termstructure.py).
    """
    check_monitor_grid(timesteps, exercise_every)
    n = int(timesteps)
    dt = maturity / n
    vs = np.asarray(vol_shape or (1.0,) * n, dtype=np.float64)
    rs = np.asarray(rate_shape or (1.0,) * n, dtype=np.float64)
    qs = np.asarray(div_shape or (1.0,) * n, dtype=np.float64)
    vol_t = vol * vs
    drift_t = (rate * rs - div_yield * qs - 0.5 * vol_t * vol_t) * dt
    sd_t = vol_t * np.sqrt(dt)
    if (sd_t <= 0.0).any():
        raise ValueError("bermudan_grid_price needs positive per-step vol")
    disc_t = np.exp(-rate * rs * dt)
    total_sd = float(np.sqrt((sd_t * sd_t).sum()))
    ln_s0 = float(np.log(spot))
    center = ln_s0 + float(drift_t.sum())
    lo = center - width_std * total_sd
    hi = center + width_std * total_sd
    x = np.linspace(lo, hi, grid_points)
    s_x = np.exp(x)

    def payoff(s: np.ndarray) -> np.ndarray:
        return np.maximum(strike - s, 0.0) if option == "put" else np.maximum(s - strike, 0.0)

    def transition(j: int) -> np.ndarray:
        # [to, from]: density of x_to given x_from under step j
        z = (x[:, None] - (x[None, :] + drift_t[j])) / sd_t[j]
        dx = x[1] - x[0]
        return np.exp(-0.5 * z * z) / (sd_t[j] * np.sqrt(2.0 * np.pi)) * dx

    # value on the grid at maturity, then walk steps back; exercise layers
    # are the monitor dates k·every (k >= 1, strictly before maturity —
    # maturity itself is the terminal payoff)
    value = payoff(s_x)
    for j in range(n - 1, -1, -1):
        value = disc_t[j] * (transition(j).T @ value)
        if j > 0 and j % exercise_every == 0:
            value = np.maximum(value, payoff(s_x))
    # collapse the t=0 point mass: value is now the t=0 continuation ON the
    # grid; the spot sits exactly mid-grid only by accident, so interpolate
    return float(np.interp(ln_s0, x, value))


__all__ = [
    "AmericanPrice",
    "bermudan_grid_price",
    "bermudan_tree_price",
    "basket_state_rows",
    "check_monitor_grid",
    "cross_fit_col_mask",
    "encode_monitor_prices",
    "lsmc_cashflows",
    "split_fit_mask",
    "lsmc_price",
    "merton_state_rows",
    "simulate_american_underlier_rows",
    "simulate_basket_american_underlier_rows",
    "simulate_heston_american_underlier_rows",
    "simulate_merton_american_underlier_rows",
]
