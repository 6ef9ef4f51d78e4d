"""Multi-asset correlated-GBM basket family — extension beyond the reference.

The reference simulates exactly one asset (gbm.py:224-257). This module adds
baskets: ``A`` correlated GBMs driven by Cholesky-mixed normals, with the
option written on the weighted arithmetic basket ``Σ wᵢ Sᵢ`` (the traded
instrument) or the geometric basket ``Π Sᵢ^wᵢ`` (whose European price has an
exact closed form under log-Euler — ``ops/analytic.py::geometric_basket_price``
— making it the sharp oracle, the same role the geometric Asian plays for the
path-dependent axis).

JAX-first: the per-step asset mixing is one ``[A, A] @ [A, rows·cols]``
contraction — einsum — and the asset axis stays leading so each
asset's state block is a contiguous VPU-shaped ``[rows, cols]`` tile.

Determinism: the same key discipline as GBM/Heston — normals addressed by
(contract_key, global row, timestep, asset), so resume is a counter and a
mesh shard reproduces exactly the rows it owns (``row_offset``).

Contract domain: the Sobol-sampled contract keeps the 6 Black-Scholes fields;
the basket structure (weights, per-asset spot/vol multipliers, correlation)
is a static, checkpointed ``BasketSpec`` on ``SimulationParams`` — per-asset
values are ``S0ᵢ = spot·spot_multipliersᵢ``, ``σᵢ = vol·vol_multipliersᵢ``.
"""

from __future__ import annotations

import enum
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from pydantic import BaseModel, ConfigDict

from spectralmc_tpu.core.errors.gbm import GBMError, InvalidSimulationParams
from spectralmc_tpu.core.result import Failure, Result, Success


class BasketCombine(enum.Enum):
    ARITHMETIC = "arithmetic"  # Σ wᵢ Sᵢ — the traded basket
    GEOMETRIC = "geometric"  # Π Sᵢ^wᵢ — lognormal, exact closed form


class BasketSpec(BaseModel):
    """Static basket structure (part of the checkpoint via SimulationParams)."""

    model_config = ConfigDict(frozen=True, extra="forbid")

    weights: tuple[float, ...]
    spot_multipliers: tuple[float, ...]
    vol_multipliers: tuple[float, ...]
    correlation: tuple[tuple[float, ...], ...]
    combine: BasketCombine = BasketCombine.ARITHMETIC

    @property
    def n_assets(self) -> int:
        return len(self.weights)


def build_basket_spec(
    *,
    weights: tuple[float, ...] | list[float],
    correlation: tuple[tuple[float, ...], ...] | list[list[float]],
    spot_multipliers: tuple[float, ...] | list[float] | None = None,
    vol_multipliers: tuple[float, ...] | list[float] | None = None,
    combine: BasketCombine | str = BasketCombine.ARITHMETIC,
) -> Result[BasketSpec, GBMError]:
    """Validated constructor: weights sum to 1, correlation symmetric PSD with
    unit diagonal, multiplier lengths match (default 1.0)."""
    w = tuple(float(x) for x in weights)
    n = len(w)
    if n < 1:
        return Failure(
            InvalidSimulationParams(field="weights", value=w, reason="need >= 1 asset")
        )
    if any(x <= 0 for x in w):
        return Failure(
            InvalidSimulationParams(field="weights", value=w, reason="must be positive")
        )
    if abs(sum(w) - 1.0) > 1e-9:
        return Failure(
            InvalidSimulationParams(field="weights", value=w, reason="must sum to 1")
        )
    sm = tuple(float(x) for x in (spot_multipliers or (1.0,) * n))
    vm = tuple(float(x) for x in (vol_multipliers or (1.0,) * n))
    for name, t in (("spot_multipliers", sm), ("vol_multipliers", vm)):
        if len(t) != n:
            return Failure(
                InvalidSimulationParams(field=name, value=t, reason=f"length must be {n}")
            )
        if any(x <= 0 for x in t):
            return Failure(
                InvalidSimulationParams(field=name, value=t, reason="must be positive")
            )
    corr = tuple(tuple(float(x) for x in row) for row in correlation)
    if len(corr) != n or any(len(r) != n for r in corr):
        return Failure(
            InvalidSimulationParams(field="correlation", value=corr, reason=f"must be {n}x{n}")
        )
    c = np.asarray(corr, dtype=np.float64)
    if not np.allclose(c, c.T, atol=1e-12):
        return Failure(
            InvalidSimulationParams(field="correlation", value=corr, reason="must be symmetric")
        )
    if not np.allclose(np.diag(c), 1.0, atol=1e-12):
        return Failure(
            InvalidSimulationParams(
                field="correlation", value=corr, reason="diagonal must be 1"
            )
        )
    try:
        np.linalg.cholesky(c)
    except np.linalg.LinAlgError:
        return Failure(
            InvalidSimulationParams(
                field="correlation", value=corr, reason="must be positive definite"
            )
        )
    if isinstance(combine, str):
        try:
            combine = BasketCombine(combine)
        except ValueError:
            return Failure(
                InvalidSimulationParams(
                    field="combine", value=combine, reason="arithmetic|geometric"
                )
            )
    return Success(
        BasketSpec(
            weights=w,
            spot_multipliers=sm,
            vol_multipliers=vm,
            correlation=corr,
            combine=combine,
        )
    )


@lru_cache(maxsize=64)
def basket_cholesky(spec: BasketSpec) -> np.ndarray:
    """Lower Cholesky factor of the correlation (float64, computed once)."""
    return np.linalg.cholesky(np.asarray(spec.correlation, dtype=np.float64))


def basket_component_normals(
    row_keys: jax.Array,
    sign: jax.Array | None,
    t: jax.Array,
    a_n: int,
    cols: int,
    dtype: jnp.dtype,
) -> jax.Array:
    """``[A, rows, cols]`` iid draws keyed (row key, timestep, asset).

    THE basket stream definition — the European simulator below and the
    American LSMC forward (ops/american.py) must both draw through this
    function so their bit streams stay identical by construction (the same
    contract ``heston_component_normals`` enforces for Heston). Antithetic
    flips the whole A-dimensional Gaussian (valid pair, correlation intact).
    """

    def per_row(k: jax.Array) -> jax.Array:
        kt = jax.random.fold_in(k, t)
        return jax.vmap(
            lambda a: jax.random.normal(jax.random.fold_in(kt, a), (cols,), dtype)
        )(jnp.arange(a_n, dtype=jnp.uint32))

    z = jnp.transpose(jax.vmap(per_row)(row_keys), (1, 0, 2))
    return z if sign is None else sign[None, :, :] * z


def basket_euler_step(
    logx: jax.Array,
    z: jax.Array,
    *,
    drift: jax.Array,
    sig_sqdt: jax.Array,
    chol: jax.Array,
) -> jax.Array:
    """ONE log-Euler step for all assets — the single source of the recursion
    (shared by the European simulator and the American LSMC forward so a
    discretization change cannot silently desync their bit streams).
    ``z`` is the pre-mix ``[A, rows, cols]`` Gaussian; the Cholesky mix is
    one matrix contraction."""
    mixed = jnp.einsum("ab,brc->arc", chol, z)
    return logx + drift[:, None, None] + sig_sqdt[:, None, None] * mixed


@partial(
    jax.jit,
    static_argnames=(
        "spec", "timesteps", "rows", "cols", "dtype", "payoff", "barrier_rel",
        "antithetic_half", "forward_start_step", "cliquet_reset_every",
        "cliquet_floor", "cliquet_cap", "sampling", "mc_seed", "term",
    ),
)
def simulate_basket_underlier_rows(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    spec: BasketSpec,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    payoff: "object",
    row_offset: jax.Array | int = 0,
    barrier_rel: float | None = None,
    antithetic_half: int | None = None,
    forward_start_step: int | None = None,
    cliquet_reset_every: int | None = None,
    cliquet_floor: float | None = None,
    cliquet_cap: float | None = None,
    sampling: "object | None" = None,
    mc_seed: int = 0,
    term: "object | None" = None,
) -> jax.Array:
    """``[rows, cols]`` basket-payoff underliers under log-Euler dynamics.

    ``contract`` is the 6-vector of ``BlackScholesContract.as_array``; asset
    ``a`` starts at ``spot·spot_multipliers[a]`` with vol
    ``vol·vol_multipliers[a]``; normals keyed by
    (contract_key, global row, timestep, asset) then Cholesky-mixed along the
    asset axis (one matrix contraction per step). With
    ``sampling=SamplingKind.SOBOL_BB`` the pre-mix normals come from the
    n_assets-factor Brownian-bridge Sobol net (ops/qmc.py).
    """
    from spectralmc_tpu.ops.gbm import PayoffKind

    a_n = spec.n_assets
    spot, _, maturity, rate, div_yield, vol = (contract[i].astype(dtype) for i in range(6))
    n = jnp.asarray(timesteps, dtype)
    dt = maturity / n
    sqrt_dt = jnp.sqrt(dt)
    weights = jnp.asarray(spec.weights, dtype)  # [A]
    sigmas = vol * jnp.asarray(spec.vol_multipliers, dtype)  # [A]
    spots = spot * jnp.asarray(spec.spot_multipliers, dtype)  # [A]
    chol = jnp.asarray(basket_cholesky(spec), dtype)  # [A, A]
    drift = (rate - div_yield - 0.5 * sigmas * sigmas) * dt  # [A]
    sig_sqdt = sigmas * sqrt_dt
    # round 4: piecewise-constant rate/div/vol curves (gbm.TermStructure
    # semantics; vol_shape scales EVERY asset's vol by the same per-step
    # factor, so the geometric combine stays an effective GBM and its exact
    # oracle composes with term_effective_black). Flat terms normalize to
    # None — bit-identical program.
    if term is not None and term.is_flat():
        term = None
    if term is None:

        def drift_at(t: jax.Array) -> jax.Array:
            return drift

        def sig_sqdt_at(t: jax.Array) -> jax.Array:
            return sig_sqdt

    else:
        vs_t, rs_t, qs_t = term.shapes(timesteps)
        vsa = jnp.asarray(vs_t, dtype)  # [T]
        sig_t = sigmas[None, :] * vsa[:, None]  # [T, A]
        drift_arr = (
            rate * jnp.asarray(rs_t, dtype)[:, None]
            - div_yield * jnp.asarray(qs_t, dtype)[:, None]
            - 0.5 * sig_t * sig_t
        ) * dt  # [T, A]
        sig_sqdt_arr = sig_t * sqrt_dt  # [T, A]

        def drift_at(t: jax.Array) -> jax.Array:
            return drift_arr[t]

        def sig_sqdt_at(t: jax.Array) -> jax.Array:
            return sig_sqdt_arr[t]

    from spectralmc_tpu.ops.gbm import SamplingKind, _row_streams

    if sampling == SamplingKind.SOBOL_BB:
        from spectralmc_tpu.ops.qmc import qmc_effective_normals_multi

        assert antithetic_half is None  # enforced by build_simulation_params
        zq = qmc_effective_normals_multi(
            contract_key,
            timesteps=timesteps,
            factors=a_n,
            rows=rows,
            cols=cols,
            dtype=dtype,
            mc_seed=mc_seed,
            row_offset=row_offset,
        )

        def normals(t: jax.Array) -> jax.Array:
            return zq[t]  # [A, rows, cols]

    else:
        row_keys, sign = _row_streams(
            contract_key,
            rows=rows,
            row_offset=row_offset,
            antithetic_half=antithetic_half,
            dtype=dtype,
        )

        def normals(t: jax.Array) -> jax.Array:
            return basket_component_normals(row_keys, sign, t, a_n, cols, dtype)

    from spectralmc_tpu.ops.gbm import (
        BARRIER_PAYOFFS,
        LOOKBACK_MAX_PAYOFFS,
        LOOKBACK_PAYOFFS,
        lookback_underlier,
    )

    geometric_time = payoff == PayoffKind.ASIAN_GEOMETRIC
    terminal = payoff in (PayoffKind.TERMINAL, PayoffKind.DIGITAL)
    barrier = payoff in BARRIER_PAYOFFS
    lookback = payoff in LOOKBACK_PAYOFFS
    track_extreme = barrier or lookback
    up = payoff == PayoffKind.BARRIER_UP_OUT or payoff in LOOKBACK_MAX_PAYOFFS
    extreme_fn = jnp.maximum if up else jnp.minimum

    def basket_value(logx: jax.Array) -> jax.Array:
        # combine along the asset axis -> [rows, cols]
        if spec.combine == BasketCombine.GEOMETRIC:
            return jnp.exp(jnp.einsum("a,arc->rc", weights, logx))
        return jnp.einsum("a,arc->rc", weights, jnp.exp(logx))


    if payoff in (PayoffKind.VARIANCE_SWAP, PayoffKind.FORWARD_START, PayoffKind.CLIQUET):
        # these kinds work on ln of the BASKET value (the payoff's underlier
        # is always the combine, matching the extreme/average conventions)
        def log_basket(logx: jax.Array) -> jax.Array:
            if spec.combine == BasketCombine.GEOMETRIC:
                return jnp.einsum("a,arc->rc", weights, logx)
            return jnp.log(jnp.einsum("a,arc->rc", weights, jnp.exp(logx)))

        if payoff == PayoffKind.CLIQUET:
            assert (  # enforced by build_simulation_params
                cliquet_reset_every is not None
                and cliquet_floor is not None
                and cliquet_cap is not None
            )
            # period returns of the BASKET value: carry the period-start
            # ln B alongside the clipped accumulator (the arithmetic
            # combine couples B to the per-asset levels, so the full path
            # walks; the geometric combine rides the same scan)
            floor_c = jnp.asarray(cliquet_floor, dtype)
            cap_c = jnp.asarray(cliquet_cap, dtype)

            def body_cq(
                carry: tuple[jax.Array, jax.Array, jax.Array], t: jax.Array
            ) -> tuple[tuple[jax.Array, jax.Array, jax.Array], None]:
                logx, start, acc = carry
                logx = basket_euler_step(
                    logx, normals(t), drift=drift_at(t), sig_sqdt=sig_sqdt_at(t), chol=chol
                )
                lb = log_basket(logx)
                boundary = (t + 1) % cliquet_reset_every == 0
                clipped = jnp.clip(jnp.exp(lb - start) - 1.0, floor_c, cap_c)
                acc = jnp.where(boundary, acc + clipped, acc)
                start = jnp.where(boundary, lb, start)
                return (logx, start, acc), None

            log0_c = jnp.zeros((a_n, rows, cols), dtype) + jnp.log(spots)[:, None, None]
            (_, _, acc_cq), _ = jax.lax.scan(
                body_cq,
                (log0_c, log_basket(log0_c), jnp.zeros((rows, cols), dtype)),
                jnp.arange(timesteps),
            )
            return acc_cq

        if payoff == PayoffKind.FORWARD_START:
            assert forward_start_step is not None  # build_simulation_params

            # capture ln B_m (state after step m−1); the arithmetic combine
            # couples B_m to the per-asset levels, so the full path walks
            def body_fs(
                carry: tuple[jax.Array, jax.Array], t: jax.Array
            ) -> tuple[tuple[jax.Array, jax.Array], None]:
                logx, cap = carry
                logx = basket_euler_step(
                    logx, normals(t), drift=drift_at(t), sig_sqdt=sig_sqdt_at(t), chol=chol
                )
                cap = jnp.where(t == forward_start_step - 1, log_basket(logx), cap)
                return (logx, cap), None

            log0_f = jnp.zeros((a_n, rows, cols), dtype) + jnp.log(spots)[:, None, None]
            b0 = log_basket(log0_f)
            (logx_f, cap_f), _ = jax.lax.scan(
                body_fs, (log0_f, b0), jnp.arange(timesteps)
            )
            # u = B₀·B_T/B_m (ops/gbm.py::PayoffKind.FORWARD_START)
            return jnp.exp(b0 + log_basket(logx_f) - cap_f)

        def body_var(
            carry: tuple[jax.Array, jax.Array, jax.Array], t: jax.Array
        ) -> tuple[tuple[jax.Array, jax.Array, jax.Array], None]:
            logx, prev_lb, acc = carry
            logx = basket_euler_step(
                logx, normals(t), drift=drift_at(t), sig_sqdt=sig_sqdt_at(t), chol=chol
            )
            lb = log_basket(logx)
            inc = lb - prev_lb
            return (logx, lb, acc + inc * inc), None

        log0_v = jnp.zeros((a_n, rows, cols), dtype) + jnp.log(spots)[:, None, None]
        (_, _, acc_v), _ = jax.lax.scan(
            body_var,
            (log0_v, log_basket(log0_v), jnp.zeros((rows, cols), dtype)),
            jnp.arange(timesteps),
        )
        return acc_v / maturity  # annualized (ops/gbm.py::PayoffKind)

    def body(
        carry: tuple[jax.Array, jax.Array], t: jax.Array
    ) -> tuple[tuple[jax.Array, jax.Array], None]:
        logx, acc = carry
        logx = basket_euler_step(logx, normals(t), drift=drift_at(t), sig_sqdt=sig_sqdt_at(t), chol=chol)
        if track_extreme:
            # extremes monitor the BASKET value (standard basket convention)
            acc = extreme_fn(acc, basket_value(logx))
        elif not terminal:
            value = basket_value(logx)
            acc = acc + (jnp.log(value) if geometric_time else value)
        return (logx, acc), None

    log0 = jnp.zeros((a_n, rows, cols), dtype) + jnp.log(spots)[:, None, None]
    acc0 = basket_value(log0) if track_extreme else jnp.zeros((rows, cols), dtype)
    (logx, acc), _ = jax.lax.scan(body, (log0, acc0), jnp.arange(timesteps))
    if barrier:
        assert barrier_rel is not None
        strike = contract[1].astype(dtype)
        level = basket_value(log0)[0, 0] * jnp.asarray(barrier_rel, dtype)
        knocked = acc >= level if up else acc <= level
        return jnp.where(knocked, strike, basket_value(logx))
    if lookback:
        strike = contract[1].astype(dtype)
        return lookback_underlier(payoff, strike, acc, basket_value(logx))
    if payoff == PayoffKind.DIGITAL:
        # same bit stream as TERMINAL: u = K + sign(B_T − K) prices both
        # cash-or-nothing channels on the basket value
        # (ops/gbm.py::PayoffKind.DIGITAL)
        strike = contract[1].astype(dtype)
        return strike + jnp.sign(basket_value(logx) - strike)
    if terminal:
        return basket_value(logx)
    mean = acc / n
    return jnp.exp(mean) if geometric_time else mean


def basket_log_moments(
    contract: jax.Array, spec: BasketSpec, *, dtype: jnp.dtype
) -> tuple[jax.Array, jax.Array]:
    """(μ̄, s̄²): per-unit-time drift and variance of ln(geometric basket).

    ln B_t = Σ wᵢ ln Sᵢ(t) is Gaussian with mean ln G₀ + μ̄·t and variance
    s̄²·t where μ̄ = (r−q) − Σwᵢσᵢ²/2 and s̄² = wᵀΣw (Σᵢⱼ = σᵢσⱼρᵢⱼ) —
    exact under log-Euler on the discrete grid.
    """
    _, _, _, rate, div_yield, vol = (contract[i].astype(dtype) for i in range(6))
    w = jnp.asarray(spec.weights, dtype)
    sig = vol * jnp.asarray(spec.vol_multipliers, dtype)
    corr = jnp.asarray(spec.correlation, dtype)
    mu_bar = (rate - div_yield) - 0.5 * jnp.sum(w * sig * sig)
    cov = corr * sig[:, None] * sig[None, :]
    s2_bar = w @ cov @ w
    return mu_bar, s2_bar


def basket_g0(contract: jax.Array, spec: BasketSpec, *, dtype: jnp.dtype) -> jax.Array:
    """Π (S0ᵢ)^{wᵢ} — the geometric basket's initial level."""
    spot = contract[0].astype(dtype)
    w = jnp.asarray(spec.weights, dtype)
    spots = spot * jnp.asarray(spec.spot_multipliers, dtype)
    return jnp.exp(jnp.sum(w * jnp.log(spots)))


def geometric_basket_effective_gbm(
    contract: jax.Array, spec: BasketSpec, *, dtype: jnp.dtype = jnp.float64
) -> tuple[float, float, float]:
    """(G₀, σ_eff, δ_eff): the single-asset GBM the geometric basket IS.

    ln B_t = ln G₀ + μ̄ t + s̄ W_t exactly (``basket_log_moments``), i.e. the
    geometric basket follows GBM with vol σ_eff = s̄ and dividend yield
    δ_eff = r − μ̄ − s̄²/2. Any single-asset oracle then prices basket
    claims exactly — in particular ``ops/american.py::bermudan_tree_price``
    at (G₀, σ_eff, δ_eff) is a SHARP Bermudan-basket oracle (used by
    tests/test_american.py for the basket LSMC policy).
    """
    rate = float(contract[3])
    mu_bar, s2_bar = basket_log_moments(contract, spec, dtype=dtype)
    g0 = basket_g0(contract, spec, dtype=dtype)
    vol_eff = float(jnp.sqrt(s2_bar))
    div_eff = rate - float(mu_bar) - 0.5 * float(s2_bar)
    return float(g0), vol_eff, div_eff


def expected_basket_underlier_mean(
    contract: jax.Array,
    spec: BasketSpec,
    *,
    timesteps: int,
    payoff: "object",
    dtype: jnp.dtype,
    forward_start_step: int | None = None,
    cliquet_reset_every: int | None = None,
    cliquet_floor: float | None = None,
    cliquet_cap: float | None = None,
    term: "object | None" = None,
) -> jax.Array | None:
    """Analytic E[underlier] for MEAN normalization, or None if no closed form.

    Arithmetic combine: E[Σ wᵢ Sᵢ(t)] = (Σ wᵢ S0ᵢ)·e^{(r−q)t} — the GBM
    formulas scaled by the weighted spot (common rate/yield). Its geometric
    time-average has no closed form (None). Geometric combine: B_t is
    lognormal, so all three payoff kinds have closed forms (the geometric
    time-average reuses the Asian (N+1)(2N+1)/(6N) variance).
    """
    from spectralmc_tpu.ops.gbm import (
        AMERICAN_PAYOFFS,
        BARRIER_PAYOFFS,
        LOOKBACK_PAYOFFS,
        PayoffKind,
    )

    if payoff in BARRIER_PAYOFFS or payoff in AMERICAN_PAYOFFS or payoff in LOOKBACK_PAYOFFS:
        # knocked-out and running-extreme means have no closed form; the
        # American synthetic underlier's mean IS the unknown price
        return None
    spot, _, maturity, rate, div_yield, _ = (contract[i].astype(dtype) for i in range(6))
    if term is not None and term.is_flat():
        term = None
    n = jnp.asarray(timesteps, dtype)
    dt = maturity / n
    if term is not None:
        # Curve-aware means (round 4). The shared vol_shape scales every
        # asset's vol by vs[t], so the geometric combine's per-step log
        # moments scale simply: mean mu_t·dt with
        # mu_t = r·rs[t] − q·qs[t] − ½(Σwσᵢ²)·vs[t]², variance
        # s̄²·vs[t]²·dt — each formula below is the flat one with per-step
        # sums replacing N·(per-step constant). Exact, not approximate.
        vs_t, rs_t, qs_t = term.shapes(timesteps)
        vsa = jnp.asarray(vs_t, dtype)
        lin = (rate * jnp.asarray(rs_t, dtype) - div_yield * jnp.asarray(qs_t, dtype)) * dt
        if spec.combine == BasketCombine.ARITHMETIC:
            # E[B_t] = (Σ wᵢS0ᵢ)·e^{∫(r−q)} — the vol curve cancels in the
            # martingale mean, exactly as flat
            w_a = jnp.asarray(spec.weights, dtype)
            s0_a = jnp.sum(w_a * (spot * jnp.asarray(spec.spot_multipliers, dtype)))
            cum_lin = jnp.cumsum(lin)
            if payoff == PayoffKind.TERMINAL:
                return s0_a * jnp.exp(cum_lin[-1])
            if payoff == PayoffKind.ASIAN_ARITHMETIC:
                return s0_a * jnp.mean(jnp.exp(cum_lin))
            return None  # digital/ratio/period/extreme kinds: no closed form
        # geometric combine: per-step effective-GBM moments
        vol_c = contract[5].astype(dtype)
        w_g = jnp.asarray(spec.weights, dtype)
        sig = vol_c * jnp.asarray(spec.vol_multipliers, dtype)
        corr_g = jnp.asarray(spec.correlation, dtype)
        wss = jnp.sum(w_g * sig * sig)  # Σ wᵢσᵢ² (flat)
        cov_g = corr_g * sig[:, None] * sig[None, :]
        s2_flat = w_g @ cov_g @ w_g  # s̄² (flat)
        mu_dt = lin - 0.5 * wss * vsa * vsa * dt  # [T] μ̄_t·dt
        s2_dt = s2_flat * vsa * vsa * dt  # [T] s̄²_t·dt
        g0_t = basket_g0(contract, spec, dtype=dtype)
        if payoff == PayoffKind.TERMINAL:
            return g0_t * jnp.exp(jnp.sum(mu_dt + 0.5 * s2_dt))
        if payoff == PayoffKind.ASIAN_ARITHMETIC:
            return g0_t * jnp.mean(jnp.exp(jnp.cumsum(mu_dt + 0.5 * s2_dt)))
        if payoff == PayoffKind.ASIAN_GEOMETRIC:
            w_t = (n - jnp.arange(timesteps, dtype=dtype)) / n
            mu_g = jnp.log(g0_t) + jnp.sum(mu_dt * w_t)
            s2_g = jnp.sum(s2_dt * w_t * w_t)
            return jnp.exp(mu_g + 0.5 * s2_g)
        if payoff == PayoffKind.DIGITAL:
            from jax.scipy.special import erf

            strike_g = contract[1].astype(dtype)
            d2 = (jnp.log(g0_t / strike_g) + jnp.sum(mu_dt)) / jnp.sqrt(jnp.sum(s2_dt))
            return strike_g + erf(d2 / jnp.sqrt(jnp.asarray(2.0, dtype)))
        if payoff == PayoffKind.VARIANCE_SWAP:
            return jnp.sum(mu_dt * mu_dt + s2_dt) / maturity
        if payoff == PayoffKind.FORWARD_START:
            assert forward_start_step is not None
            tail = jnp.arange(timesteps) >= forward_start_step
            return g0_t * jnp.exp(jnp.sum(jnp.where(tail, mu_dt + 0.5 * s2_dt, 0.0)))
        if payoff == PayoffKind.CLIQUET:
            from spectralmc_tpu.ops.gbm import expected_clipped_lognormal_return

            assert (
                cliquet_reset_every is not None
                and cliquet_floor is not None
                and cliquet_cap is not None
            )
            periods = timesteps // cliquet_reset_every
            mu_p = jnp.sum(mu_dt.reshape(periods, cliquet_reset_every), axis=1)
            s_p = jnp.sqrt(jnp.sum(s2_dt.reshape(periods, cliquet_reset_every), axis=1))
            return jnp.sum(
                expected_clipped_lognormal_return(
                    mu_p, s_p,
                    jnp.asarray(cliquet_floor, dtype), jnp.asarray(cliquet_cap, dtype),
                )
            )
        return None
    if payoff == PayoffKind.VARIANCE_SWAP:
        if spec.combine == BasketCombine.ARITHMETIC:
            return None  # ln(Σ wᵢSᵢ) increments have no closed moments
        # geometric combine: Δln B ~ N(μ̄·dt, s̄²·dt) exactly per step, so
        # E[RV] = N·((μ̄dt)² + s̄²dt)/T (the effective-GBM map)
        mu_bar, s2_bar = basket_log_moments(contract, spec, dtype=dtype)
        return n * ((mu_bar * dt) ** 2 + s2_bar * dt) / maturity
    if payoff == PayoffKind.FORWARD_START:
        if spec.combine == BasketCombine.ARITHMETIC:
            return None  # E[B_T/B_m] of a ratio of weighted sums: no closed form
        # geometric combine: B_T/B_m is the effective GBM's tail ratio
        assert forward_start_step is not None
        mu_bar, s2_bar = basket_log_moments(contract, spec, dtype=dtype)
        n_tail = jnp.asarray(timesteps - forward_start_step, dtype)
        g0 = basket_g0(contract, spec, dtype=dtype)
        return g0 * jnp.exp((mu_bar + 0.5 * s2_bar) * dt * n_tail)
    if payoff == PayoffKind.CLIQUET:
        if spec.combine == BasketCombine.ARITHMETIC:
            return None  # period returns of a weighted sum: no closed form
        # geometric combine: each period return of B is lognormal at the
        # effective-GBM moments, so E[u] = periods·E[clip] (ops/gbm.py)
        from spectralmc_tpu.ops.gbm import expected_clipped_lognormal_return

        assert (
            cliquet_reset_every is not None
            and cliquet_floor is not None
            and cliquet_cap is not None
        )
        mu_bar, s2_bar = basket_log_moments(contract, spec, dtype=dtype)
        k_c = jnp.asarray(cliquet_reset_every, dtype)
        periods = timesteps // cliquet_reset_every
        mu_p = mu_bar * dt * k_c
        s_p = jnp.sqrt(s2_bar * dt * k_c)
        return jnp.asarray(periods, dtype) * expected_clipped_lognormal_return(
            mu_p, s_p, jnp.asarray(cliquet_floor, dtype), jnp.asarray(cliquet_cap, dtype)
        )
    if spec.combine == BasketCombine.ARITHMETIC:
        if payoff == PayoffKind.DIGITAL:
            return None  # P(B_arith > K) has no closed form
        w = jnp.asarray(spec.weights, dtype)
        s0 = jnp.sum(w * (spot * jnp.asarray(spec.spot_multipliers, dtype)))
        if payoff == PayoffKind.TERMINAL:
            return s0 * jnp.exp((rate - div_yield) * maturity)
        if payoff == PayoffKind.ASIAN_ARITHMETIC:
            g = jnp.exp((rate - div_yield) * dt)
            series = jnp.where(jnp.abs(g - 1.0) < 1e-12, n, g * (g**n - 1.0) / (g - 1.0))
            return s0 * series / n
        return None  # geometric time-average of an arithmetic basket
    mu_bar, s2_bar = basket_log_moments(contract, spec, dtype=dtype)
    g0 = basket_g0(contract, spec, dtype=dtype)
    if payoff == PayoffKind.DIGITAL:
        # ln B_T exactly Gaussian: E[u] = K + 2·N(d2_eff) − 1 at the
        # effective-GBM parameters (ops/gbm.py::PayoffKind.DIGITAL)
        from jax.scipy.special import erf

        strike = contract[1].astype(dtype)
        var = s2_bar * maturity
        d2 = (jnp.log(g0 / strike) + mu_bar * maturity) / jnp.sqrt(var)
        return strike + erf(d2 / jnp.sqrt(jnp.asarray(2.0, dtype)))
    if payoff == PayoffKind.TERMINAL:
        return g0 * jnp.exp((mu_bar + 0.5 * s2_bar) * maturity)
    if payoff == PayoffKind.ASIAN_ARITHMETIC:
        g = jnp.exp((mu_bar + 0.5 * s2_bar) * dt)
        series = jnp.where(jnp.abs(g - 1.0) < 1e-12, n, g * (g**n - 1.0) / (g - 1.0))
        return g0 * series / n
    # geometric time-average of the geometric basket: exactly lognormal
    mu = jnp.log(g0) + mu_bar * dt * (n + 1.0) / 2.0
    s2 = s2_bar * dt * (n + 1.0) * (2.0 * n + 1.0) / (6.0 * n)
    return jnp.exp(mu + 0.5 * s2)


__all__ = [
    "BasketCombine",
    "BasketSpec",
    "basket_cholesky",
    "basket_component_normals",
    "basket_euler_step",
    "basket_g0",
    "basket_log_moments",
    "build_basket_spec",
    "geometric_basket_effective_gbm",
    "expected_basket_underlier_mean",
    "simulate_basket_underlier_rows",
]
