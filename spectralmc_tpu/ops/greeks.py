"""Option Greeks — pathwise (IPA) Monte-Carlo sensitivities by autodiff.

Capability beyond the reference: its path generator is an opaque Numba-CUDA
JIT kernel (reference gbm.py:224-257), invisible to torch autograd, so
Monte-Carlo Greeks are impossible there without hand-written estimators or
bump-and-reprice reruns. Here the whole simulator is a JAX program, so

    greeks = jax.grad(mean discounted payoff)(contract vector)

is the pathwise-derivative (infinitesimal-perturbation-analysis) estimator —
computed in ONE reverse pass over the same fused Sobol→MC→payoff pipeline the
pricer runs, with the same normals: key derivation (`fold_in`) depends only on
integer indices, never on contract values, so differentiation holds the noise
fixed (common random numbers), which is exactly the IPA validity condition
for the a.e.-differentiable vanilla/Asian payoffs used here.

Three estimator families:

* ``mc_greeks`` — first-order Greeks of the MC price for any
  (ModelKind, PayoffKind) the engines support, plus gamma via a
  central difference of the *pathwise delta* under common random numbers
  (the standard mixed IPA/FD estimator — pure second-order IPA of a kinked
  payoff is a.e. zero and inconsistent).
* ``analytic_greeks`` — exact Greeks by autodiff of the closed-form oracles
  (``ops/analytic.py``). Because MC and oracle differentiate the SAME
  parametrization, every sign/scale convention matches by construction.
* ``GbmCVNNPricer.predict_greeks`` (training/trainer.py) — Greeks of the
  *learned* pricer: gradient through IFFT∘CVNN, smooth in all inputs, so
  even gamma is a plain second derivative.

Engine selection (``greeks_engine``): for (GBM, TERMINAL, log-Euler) a
PALLAS-configured sim keeps the fused hardware kernel — its backward pass is
the ANALYTIC pathwise rule computed from the kernel's own forward samples
(``gbm_pallas.terminal_pathwise_vjp``; no kernel backward, no second bit
stream), so Greeks run at kernel speed. Every other combination runs the
autodiff-transparent XLA (`lax.scan`) engine. The returned
``MCGreeks.engine`` records which one ran.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Mapping, Protocol

from jax.typing import DTypeLike

import jax
import jax.numpy as jnp

from spectralmc_tpu.ops.analytic import black_scholes_price, geometric_asian_price
from spectralmc_tpu.ops.gbm import (
    ForwardNormalization,
    PayoffKind,
    SimImplementation,
    SimulationParams,
    terminal_to_prices,
)


class SupportsAsArray(Protocol):
    """Any contract model (BlackScholes/Heston/Merton...): a frozen pydantic
    record exposing ``as_array(dtype) -> jax.Array`` in its field order."""

    def as_array(self, dtype: DTypeLike = ...) -> jax.Array: ...


class OptionSide(enum.Enum):
    PUT = "put"
    CALL = "call"


@dataclass(frozen=True)
class MCGreeks:
    """One contract's price + full first-order sensitivity vector.

    ``by_field`` maps every contract field (the model family's own fields —
    6 for GBM, 10 for Heston) to ∂price/∂field. Named accessors cover the
    classic Greeks; ``theta`` follows the market convention −∂price/∂T.
    """

    price: float
    by_field: Mapping[str, float]
    gamma: float
    engine: SimImplementation

    @property
    def delta(self) -> float:
        return self.by_field["spot"]

    @property
    def dual_delta(self) -> float:
        return self.by_field["strike"]

    @property
    def theta(self) -> float:
        return -self.by_field["maturity"]

    @property
    def rho(self) -> float:
        return self.by_field["rate"]

    @property
    def div_rho(self) -> float:
        return self.by_field["div_yield"]

    @property
    def vega(self) -> float:
        """∂price/∂vol — GBM only (Heston exposes v0/xi/… sensitivities)."""
        return self.by_field["vol"]



def _check_american_side(sim: SimulationParams, option: OptionSide) -> OptionSide:
    """Validate + remap the option side for the AMERICAN payoff kinds.

    The synthetic underlier encodes ONE side's LSMC cashflow through the put
    channel (PayoffKind docstring); the opposite channel is identically
    zero, so its "Greeks" would be silently zero. Used by every estimator
    factory so no public entry point can produce that silent zero.
    """
    from spectralmc_tpu.ops.gbm import AMERICAN_PAYOFFS, PayoffKind

    if sim.payoff not in AMERICAN_PAYOFFS:
        return option
    configured = (
        OptionSide.PUT if sim.payoff == PayoffKind.AMERICAN_PUT else OptionSide.CALL
    )
    if option != configured:
        raise ValueError(
            f"sim.payoff={sim.payoff.value!r} prices the {configured.value} "
            "side only; early exercise has no parity route to the other "
            "side — configure the other AMERICAN kind"
        )
    return OptionSide.PUT  # the put channel carries the configured side


def make_mc_price_fn(
    sim: SimulationParams, *, option: OptionSide
) -> Callable[[jax.Array, jax.Array], jax.Array]:
    """(draw_index, contract_vector) → scalar MC price, differentiable.

    The same Sobol→simulate→normalize→discount pipeline as
    ``training/step.py::make_mc_spectrum`` but reduced to the mean discounted
    payoff instead of the spectrum. Engine per ``greeks_engine`` (Pallas
    kernel + analytic pathwise VJP where eligible, XLA otherwise).
    """
    from spectralmc_tpu.ops.dispatch import make_mean_target, make_underlier_simulator
    from spectralmc_tpu.ops.gbm import BARRIER_PAYOFFS, PayoffKind

    if sim.payoff in BARRIER_PAYOFFS or sim.payoff == PayoffKind.DIGITAL:
        # IPA differentiates through an indicator (the knockout flag / the
        # digital's sign), whose pathwise derivative is zero a.e. — the
        # estimator would silently drop the discontinuity's contribution.
        # Refuse rather than mislead (the bump-and-reprice estimator lives
        # at ``bump_greeks``).
        raise ValueError(
            "pathwise (IPA) Greeks are invalid for indicator payoffs "
            f"({sim.payoff.value}); use bump_greeks (bump-and-reprice under "
            "common random numbers) or differentiate the learned pricer "
            "(predict_greeks) instead"
        )
    # NOTE for the AMERICAN kinds: jax.grad through the LSMC program is the
    # standard fixed-policy pathwise estimator (the regression solve IS
    # differentiated, but the exercise indicator is treated as locally
    # constant). First-order Greeks are consistent by the envelope argument;
    # gamma uses the same mixed estimator as the vanillas.
    option = _check_american_side(sim, option)
    return _make_raw_price_fn(sim, option=option)


def greeks_engine(sim: SimulationParams) -> SimImplementation:
    """The engine the Greeks estimators will ACTUALLY differentiate/bump.

    PALLAS-configured sims keep the hardware kernel for (GBM, TERMINAL,
    log-Euler): the kernel's backward pass is the analytic pathwise rule
    over its own forward samples (``gbm_pallas.terminal_pathwise_vjp``), so
    Greeks run at kernel speed on the SAME bit stream the pricer consumes.
    Every other (model, payoff, scheme) combination runs the autodiff-
    transparent XLA engine — `MCGreeks.engine` records the choice.
    """
    from spectralmc_tpu.ops.gbm import ModelKind, PathScheme, PayoffKind, SamplingKind

    if (
        sim.implementation == SimImplementation.PALLAS
        and sim.sampling == SamplingKind.PSEUDO
        and sim.model == ModelKind.GBM
        and sim.payoff == PayoffKind.TERMINAL
        and sim.scheme == PathScheme.LOG_EULER
        # term structures keep the kernel: the pathwise rule generalizes
        # with the curve's effective factors (terminal_pathwise_vjp)
    ):
        from spectralmc_tpu.ops.gbm_pallas import pallas_supported

        if pallas_supported(
            dtype=sim.precision.to_jnp(),
            rows=sim.batches_per_mc_run,
            cols=sim.network_size,
        ):
            return SimImplementation.PALLAS
    return SimImplementation.XLA


def _make_raw_price_fn(
    sim: SimulationParams, *, option: OptionSide
) -> Callable[[jax.Array, jax.Array], jax.Array]:
    """The Sobol→simulate→normalize→discount mean-payoff program, no estimator
    gating — shared by the IPA path (``make_mc_price_fn``) and the
    bump-and-reprice path (``bump_greeks``), so both differentiate/ bump the
    exact pipeline the pricer runs. Engine per ``greeks_engine``."""
    from spectralmc_tpu.ops.dispatch import make_mean_target, make_underlier_simulator

    dtype = sim.precision.to_jnp()
    base_key = jax.random.PRNGKey(sim.mc_seed)
    normalize = sim.normalization == ForwardNormalization.MEAN
    if greeks_engine(sim) == SimImplementation.PALLAS:
        from spectralmc_tpu.ops.gbm_pallas import simulate_terminal_rows_pallas_diff

        anti = sim.batches_per_mc_run // 2 if sim.antithetic else None

        def simulate(key: jax.Array, contract: jax.Array) -> jax.Array:
            return simulate_terminal_rows_pallas_diff(
                key,
                contract,
                timesteps=sim.timesteps,
                rows=sim.batches_per_mc_run,
                cols=sim.network_size,
                dtype=dtype,
                antithetic_half=anti,
                term=sim.term,
            )
    else:
        xla_sim = sim.model_copy(update={"implementation": SimImplementation.XLA})
        simulate = make_underlier_simulator(xla_sim, rows=xla_sim.batches_per_mc_run)
    mean_target = make_mean_target(sim)

    def price(draw_index: jax.Array, contract: jax.Array) -> jax.Array:
        key = jax.random.fold_in(base_key, draw_index)
        rows = simulate(key, contract)
        prices = terminal_to_prices(
            rows.reshape(-1),
            contract,
            normalize=normalize,
            dtype=dtype,
            mean_target=mean_target(contract),
            term=sim.term,
        )
        payoffs = prices.put_payoffs if option == OptionSide.PUT else prices.call_payoffs
        return jnp.mean(payoffs)

    return price


def make_mc_greeks_fn(
    sim: SimulationParams, *, option: OptionSide, gamma_rel_bump: float = 1e-2
) -> Callable[[jax.Array, jax.Array], tuple[jax.Array, jax.Array, jax.Array]]:
    """(draw_index, contract) → (price, grad_vector, gamma), one jitted program.

    gamma = (Δ(S₀(1+h)) − Δ(S₀(1−h))) / (2·h·S₀) with the SAME key — the
    central difference of the pathwise delta under common random numbers.
    Bias is O(h²) plus a kink-crossing term that vanishes with the path count;
    ``gamma_rel_bump`` trades them (1e-2 of spot is the classic choice).
    """
    price_fn = make_mc_price_fn(sim, option=option)
    value_and_grad = jax.value_and_grad(price_fn, argnums=1)
    delta_fn = jax.grad(price_fn, argnums=1)

    @jax.jit
    def run(
        draw_index: jax.Array, contract: jax.Array
    ) -> tuple[jax.Array, jax.Array, jax.Array]:
        price, grad = value_and_grad(draw_index, contract)
        h = gamma_rel_bump * contract[0]
        bump = jnp.zeros_like(contract).at[0].set(h)
        delta_up = delta_fn(draw_index, contract + bump)[0]
        delta_dn = delta_fn(draw_index, contract - bump)[0]
        gamma = (delta_up - delta_dn) / (2.0 * h)
        return price, grad, gamma

    return run


def mc_greeks(
    sim: SimulationParams,
    contract: SupportsAsArray,
    *,
    option: OptionSide = OptionSide.CALL,
    draw_index: int | None = None,
    gamma_rel_bump: float = 1e-2,
) -> MCGreeks:
    """Pathwise MC Greeks for one contract (any ModelKind; any NON-BARRIER
    payoff kind — knockouts are refused, see ``make_mc_price_fn``).

    ``contract`` is a ``BlackScholesContract`` / ``HestonContract`` /
    ``MertonContract`` (anything with ``as_array`` + the sim's field set).
    ``draw_index`` defaults to the sim's checkpointed ``skip`` — the same
    draw the pricer would consume next.

    MERTON_JUMP caveat: the Poisson counts are sampled under
    ``stop_gradient`` (ops/merton.py), so ``by_field["lam"]`` is the
    fixed-count envelope derivative — it carries the compensator channel
    but not the discrete count channel. Under MEAN forward normalization
    the envelope is exactly ~0: the compensator is a uniform path rescale
    the normalization cancels. Use ``bump_greeks`` for the full lam
    sensitivity; every other Merton field is exact pathwise.
    """
    from spectralmc_tpu.ops.dispatch import contract_class

    fields = tuple(contract_class(sim).model_fields.keys())
    dtype = sim.precision.to_jnp()
    arr = contract.as_array(dtype)
    idx = sim.skip if draw_index is None else draw_index
    run = make_mc_greeks_fn(sim, option=option, gamma_rel_bump=gamma_rel_bump)
    price, grad, gamma = run(jnp.asarray(idx, jnp.uint32), arr)
    grad_host = [float(g) for g in grad]
    return MCGreeks(
        price=float(price),
        by_field=dict(zip(fields, grad_host)),
        gamma=float(gamma),
        engine=greeks_engine(sim),
    )


# --------------------------------------------------------------------------
# Bucketed curve Greeks — sensitivity ladders along a TermStructure
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class TermBucketGreeks:
    """Per-step sensitivity ladders of one contract's MC price to the curve.

    ``vega_buckets[t] = ∂price/∂vol_shape[t]`` etc. — the desk's bucketed
    vega/rho/dividend ladders along the simulation grid. Scalars relate by
    Euler homogeneity: the price depends on ``vol`` only through the
    products ``vol·vol_shape[t]``, so
    ``Σ_t vega_buckets[t]·vol_shape[t] = vol·∂price/∂vol`` (and likewise
    rate/div) — tested against ``mc_greeks`` on the same draw.
    """

    price: float
    vega_buckets: tuple[float, ...]
    rho_buckets: tuple[float, ...]
    div_buckets: tuple[float, ...]
    engine: SimImplementation


def term_bucket_greeks(
    sim: SimulationParams,
    contract: SupportsAsArray,
    *,
    option: OptionSide = OptionSide.CALL,
    draw_index: int | None = None,
) -> TermBucketGreeks:
    """Pathwise ladders ∂price/∂{vol,rate,div}_shape[t] for a curved-market
    GBM sim — ONE reverse pass with the curve shapes as traced inputs.

    Impossible through ``mc_greeks`` (shapes are static config there) and
    impossible in the reference at any price (its kernel is opaque to
    autograd and its market data is flat scalars). Supported payoffs:
    TERMINAL, the Asian kinds, VARIANCE_SWAP, FORWARD_START and CLIQUET —
    a vol-strip ladder of a variance swap or a cliquet is the natural hedge
    report for those products (knockouts
    have no valid pathwise derivative — ``bump_greeks`` covers them; the
    LSMC payoffs' regression consumes static curves and is out of scope).
    """
    from spectralmc_tpu.ops.gbm import (
        AMERICAN_PAYOFFS,
        BARRIER_PAYOFFS,
        ModelKind,
        PathScheme,
        _normals_source,
    )

    if sim.model != ModelKind.GBM:
        raise ValueError("term_bucket_greeks: curves exist for the GBM model only")
    if sim.term is None:
        raise ValueError(
            "term_bucket_greeks needs sim.term (flat markets: mc_greeks gives "
            "the scalar vega/rho)"
        )
    if sim.payoff in BARRIER_PAYOFFS or sim.payoff == PayoffKind.DIGITAL:
        raise ValueError(
            "pathwise ladders are invalid for indicator payoffs "
            f"({sim.payoff.value}); use bump_greeks on the scalar fields"
        )
    if sim.payoff in AMERICAN_PAYOFFS:
        raise ValueError(
            "curve ladders for the LSMC payoffs are unsupported (the exercise "
            "policy consumes static curves); bump the scalar fields instead"
        )
    from spectralmc_tpu.ops.gbm import LOOKBACK_PAYOFFS

    if sim.payoff in LOOKBACK_PAYOFFS:
        raise ValueError(
            "curve ladders for the lookback kinds are not implemented (the "
            "ladder program rebuilds the payoff and carries no running "
            "extreme); mc_greeks gives the scalar greeks — IPA is valid for "
            "lookbacks — and bump_greeks covers the scalar fields"
        )
    dtype = sim.precision.to_jnp()
    timesteps = sim.timesteps
    rows, cols = sim.batches_per_mc_run, sim.network_size
    arr = contract.as_array(dtype)
    idx = sim.skip if draw_index is None else draw_index
    key = jax.random.fold_in(
        jax.random.PRNGKey(sim.mc_seed), jnp.asarray(idx, jnp.uint32)
    )
    anti = rows // 2 if sim.antithetic else None
    normalize = sim.normalization == ForwardNormalization.MEAN
    geometric = sim.payoff == PayoffKind.ASIAN_GEOMETRIC
    variance = sim.payoff == PayoffKind.VARIANCE_SWAP
    fstart = sim.payoff == PayoffKind.FORWARD_START
    m_fs = sim.forward_start_step if fstart else None
    cliquet = sim.payoff == PayoffKind.CLIQUET
    k_cq = sim.cliquet_reset_every
    f_cq, c_cq = sim.cliquet_floor, sim.cliquet_cap
    log_euler = sim.scheme == PathScheme.LOG_EULER

    normals = _normals_source(
        key,
        timesteps=timesteps,
        rows=rows,
        cols=cols,
        dtype=dtype,
        row_offset=0,
        antithetic_half=anti,
        sampling=sim.sampling,
        mc_seed=sim.mc_seed,
    )
    spot, strike, maturity, rate, div_yield, vol = (arr[i] for i in range(6))
    n = jnp.asarray(timesteps, dtype)
    dt = maturity / n
    sqrt_dt = jnp.sqrt(dt)
    payoff_kind = sim.payoff

    @jax.jit
    def price_and_ladders(
        shapes: tuple[jax.Array, jax.Array, jax.Array],
    ) -> tuple[jax.Array, tuple[jax.Array, jax.Array, jax.Array]]:
        def price(sh: tuple[jax.Array, jax.Array, jax.Array]) -> jax.Array:
            vsa, rsa, qsa = sh
            vol_t = vol * vsa
            lin = (rate * rsa - div_yield * qsa) * dt  # [T]
            if log_euler:
                drift = lin - 0.5 * vol_t * vol_t * dt
                vstep = vol_t * sqrt_dt

                def body(
                    carry: tuple[jax.Array, jax.Array], t: jax.Array
                ) -> tuple[tuple[jax.Array, jax.Array], None]:
                    logx, acc = carry
                    if variance:
                        inc = drift[t] + vstep[t] * normals(t)
                        logx = logx + inc
                        acc = acc + inc * inc
                    elif fstart:
                        # tail-masked log-ratio: zeros before t_m keep the
                        # accumulation bit-identical to the tail-only scan
                        inc = drift[t] + vstep[t] * normals(t)
                        logx = logx + inc
                        acc = acc + jnp.where(t >= m_fs, inc, 0.0)
                    elif cliquet:
                        # the logx slot carries the RUNNING PERIOD log-return
                        # (init 0; reset at boundaries) — the clipped-sum
                        # scan of simulate_underlier_rows re-expressed with
                        # the curves as traced inputs
                        logx = logx + drift[t] + vstep[t] * normals(t)
                        boundary = (t + 1) % k_cq == 0
                        clipped = jnp.clip(jnp.exp(logx) - 1.0, f_cq, c_cq)
                        acc = jnp.where(boundary, acc + clipped, acc)
                        logx = jnp.where(boundary, 0.0, logx)
                    else:
                        logx = logx + drift[t] + vstep[t] * normals(t)
                        acc = acc + (logx if geometric else jnp.exp(logx))
                    return (logx, acc), None

                log0 = jnp.full((rows, cols), 0.0, dtype) + (
                    0.0 if cliquet else jnp.log(spot)
                )
                (log_t, acc), _ = jax.lax.scan(
                    body, (log0, jnp.zeros((rows, cols), dtype)), jnp.arange(timesteps)
                )
                terminal = jnp.exp(log_t)
            else:
                growth = 1.0 + lin
                vstep = vol_t * sqrt_dt

                def body_e(
                    carry: tuple[jax.Array, jax.Array], t: jax.Array
                ) -> tuple[tuple[jax.Array, jax.Array], None]:
                    x, acc = carry
                    if variance:
                        g = growth[t] + vstep[t] * normals(t)
                        x = jnp.abs(x * g)
                        inc = jnp.log(jnp.abs(g))
                        acc = acc + inc * inc
                    elif fstart:
                        g = growth[t] + vstep[t] * normals(t)
                        x = jnp.abs(x * g)
                        acc = acc + jnp.where(t >= m_fs, jnp.log(jnp.abs(g)), 0.0)
                    elif cliquet:
                        # the x slot carries the RUNNING PERIOD growth ratio
                        g = growth[t] + vstep[t] * normals(t)
                        x = jnp.abs(x * g)
                        boundary = (t + 1) % k_cq == 0
                        clipped = jnp.clip(x - 1.0, f_cq, c_cq)
                        acc = jnp.where(boundary, acc + clipped, acc)
                        x = jnp.where(boundary, 1.0, x)
                    else:
                        x = jnp.abs(x * (growth[t] + vstep[t] * normals(t)))
                        acc = acc + (jnp.log(x) if geometric else x)
                    return (x, acc), None

                x0 = jnp.full((rows, cols), 1.0, dtype) * (
                    1.0 if cliquet else spot
                )
                (terminal, acc), _ = jax.lax.scan(
                    body_e, (x0, jnp.zeros((rows, cols), dtype)), jnp.arange(timesteps)
                )
            if payoff_kind == PayoffKind.TERMINAL:
                u = terminal
            elif variance:
                u = acc / maturity  # annualized realized variance
            elif fstart:
                u = spot * jnp.exp(acc)  # spot·S_T/S_m from the tail sum
            elif cliquet:
                u = acc  # the clipped-return sum IS the underlier
            else:
                mean_acc = acc / n
                u = jnp.exp(mean_acc) if geometric else mean_acc
            # curve-consistent mean target + discounting (traced mirrors of
            # expected_underlier_mean / terminal_to_prices term branches)
            cum = jnp.cumsum(lin)
            if normalize:
                if variance:
                    a_v = lin - 0.5 * vol_t * vol_t * dt
                    target = jnp.sum(a_v * a_v + vol_t * vol_t * dt) / maturity
                elif fstart:
                    tail_mask = jnp.arange(timesteps) >= m_fs
                    target = spot * jnp.exp(jnp.sum(jnp.where(tail_mask, lin, 0.0)))
                elif payoff_kind == PayoffKind.TERMINAL:
                    target = spot * jnp.exp(cum[-1])
                elif payoff_kind == PayoffKind.ASIAN_ARITHMETIC:
                    target = spot * jnp.mean(jnp.exp(cum))
                else:
                    w = (n - jnp.arange(timesteps, dtype=dtype)) / n
                    a = lin - 0.5 * vol_t * vol_t * dt
                    mu = jnp.log(spot) + jnp.sum(a * w)
                    s2 = jnp.sum(vol_t * vol_t * dt * w * w)
                    target = jnp.exp(mu + 0.5 * s2)
                u = u * (target / jnp.mean(u))
            df = jnp.exp(-rate * jnp.mean(rsa) * maturity)
            payoff = (
                jnp.maximum(strike - u, 0.0)
                if option == OptionSide.PUT
                else jnp.maximum(u - strike, 0.0)
            )
            return df * jnp.mean(payoff)

        return jax.value_and_grad(price)(shapes)

    vs0, rs0, qs0 = (jnp.asarray(s, dtype) for s in sim.term.shapes(timesteps))
    p, (g_v, g_r, g_q) = price_and_ladders((vs0, rs0, qs0))
    return TermBucketGreeks(
        price=float(p),
        vega_buckets=tuple(float(x) for x in g_v),
        rho_buckets=tuple(float(x) for x in g_r),
        div_buckets=tuple(float(x) for x in g_q),
        engine=SimImplementation.XLA,
    )


# --------------------------------------------------------------------------
# Bump-and-reprice Greeks — the estimator for kinked/indicator payoffs
# --------------------------------------------------------------------------


def make_bump_greeks_fn(
    sim: SimulationParams,
    *,
    option: OptionSide,
    rel_bump: float = 1e-2,
) -> Callable[[jax.Array, jax.Array], tuple[jax.Array, jax.Array, jax.Array]]:
    """(draw_index, contract) → (price, grad_vector, gamma) by central finite
    differences of the MC price under COMMON RANDOM NUMBERS — all 2D+1
    evaluations share one ``draw_index``, so the noise cancels to first
    order and only the policy/indicator response remains.

    This is the estimator for payoffs whose pathwise derivative is invalid
    (knockout indicators — the refusal in ``make_mc_price_fn`` points here).
    It works for every (ModelKind, PayoffKind) the engines support. The
    2D+1 bumped contracts run as ONE vmapped program (a single dispatch).

    Bump sizing: h_i = rel_bump · max(|x_i|, 1e-3) per field. For barriers,
    bias near the knockout level is O(h) in the crossing probability — the
    classic FD/indicator tradeoff; shrink ``rel_bump`` with the path count.
    """
    option = _check_american_side(sim, option)
    price_fn = _make_raw_price_fn(sim, option=option)
    floor = 1e-3

    @jax.jit
    def run(
        draw_index: jax.Array, contract: jax.Array
    ) -> tuple[jax.Array, jax.Array, jax.Array]:
        d = contract.shape[0]
        h = rel_bump * jnp.maximum(jnp.abs(contract), floor)  # [D]
        bumps = jnp.eye(d, dtype=contract.dtype) * h[:, None]  # [D, D]
        grid = jnp.concatenate(
            [contract[None, :], contract[None, :] + bumps, contract[None, :] - bumps],
            axis=0,
        )  # [2D+1, D]
        prices = jax.vmap(lambda c: price_fn(draw_index, c))(grid)
        base = prices[0]
        up, dn = prices[1 : d + 1], prices[d + 1 :]
        grad = (up - dn) / (2.0 * h)
        gamma = (up[0] - 2.0 * base + dn[0]) / (h[0] * h[0])
        return base, grad, gamma

    return run


def bump_greeks(
    sim: SimulationParams,
    contract: SupportsAsArray,
    *,
    option: OptionSide = OptionSide.CALL,
    draw_index: int | None = None,
    rel_bump: float = 1e-2,
) -> MCGreeks:
    """Bump-and-reprice MC Greeks for one contract — valid for EVERY payoff
    kind, including the knockouts the IPA estimator refuses
    (``make_mc_price_fn``). Same conventions as ``mc_greeks``.
    """
    from spectralmc_tpu.ops.dispatch import contract_class

    # American side validation/remap happens inside make_bump_greeks_fn
    fields = tuple(contract_class(sim).model_fields.keys())
    dtype = sim.precision.to_jnp()
    arr = contract.as_array(dtype)
    idx = sim.skip if draw_index is None else draw_index
    run = make_bump_greeks_fn(sim, option=option, rel_bump=rel_bump)
    price, grad, gamma = run(jnp.asarray(idx, jnp.uint32), arr)
    return MCGreeks(
        price=float(price),
        by_field=dict(zip(fields, (float(g) for g in grad))),
        gamma=float(gamma),
        engine=greeks_engine(sim),
    )


def knock_in_price(
    sim: SimulationParams,
    contract: SupportsAsArray,
    *,
    option: OptionSide = OptionSide.CALL,
    draw_index: int | None = None,
) -> float:
    """Knock-IN price by in = vanilla − out under COMMON RANDOM NUMBERS.

    The barrier engines price knock-OUTs; knock-ins follow by the exact
    pathwise identity (every path either knocks or it doesn't, so
    in + out = vanilla payoff-by-payoff). Both legs here draw the SAME
    (contract_key, row, timestep) stream — the barrier walk takes identical
    increments to the terminal walk — so the difference carries only the
    knocked paths' payoffs and its MC error is the low-variance difference,
    not two independent errors. ``sim.payoff`` must be a BARRIER kind; the
    vanilla leg prices TERMINAL with normalization off (rescaling would
    break the pathwise pairing). Works for every ModelKind with a barrier
    engine (GBM, Heston, baskets).
    """
    from spectralmc_tpu.ops.gbm import BARRIER_PAYOFFS, ForwardNormalization, PayoffKind

    if sim.payoff not in BARRIER_PAYOFFS:
        raise ValueError(
            f"knock_in_price needs a barrier payoff; got {sim.payoff.value!r}"
        )
    vanilla_sim = sim.model_copy(
        update={
            "payoff": PayoffKind.TERMINAL,
            "barrier_rel": None,
            "normalization": ForwardNormalization.NONE,
        }
    )
    out_fn = _make_raw_price_fn(sim, option=option)
    vanilla_fn = _make_raw_price_fn(vanilla_sim, option=option)
    dtype = sim.precision.to_jnp()
    arr = contract.as_array(dtype)
    idx = jnp.asarray(sim.skip if draw_index is None else draw_index, jnp.uint32)

    @jax.jit
    def run(i: jax.Array, c: jax.Array) -> jax.Array:
        return vanilla_fn(i, c) - out_fn(i, c)

    return float(run(idx, arr))


# --------------------------------------------------------------------------
# Analytic oracle Greeks — autodiff of the closed forms
# --------------------------------------------------------------------------

_BS_FIELDS = ("spot", "strike", "maturity", "rate", "div_yield", "vol")


def make_analytic_price_fn(
    *, option: OptionSide, payoff: PayoffKind = PayoffKind.TERMINAL, timesteps: int = 1
) -> Callable[[jax.Array], jax.Array]:
    """contract 6-vector → exact price (TERMINAL Black or geometric Asian)."""
    if payoff == PayoffKind.ASIAN_ARITHMETIC:
        raise ValueError("arithmetic Asian has no closed form; use mc_greeks")

    def price(contract: jax.Array) -> jax.Array:
        args = tuple(contract[i] for i in range(6))
        if payoff == PayoffKind.TERMINAL:
            prices = black_scholes_price(*args)
        else:
            prices = geometric_asian_price(*args, timesteps=timesteps)
        return prices.put if option == OptionSide.PUT else prices.call

    return price


def analytic_greeks(
    contract: SupportsAsArray,
    *,
    option: OptionSide = OptionSide.CALL,
    payoff: PayoffKind = PayoffKind.TERMINAL,
    timesteps: int = 1,
    dtype: DTypeLike | None = None,
) -> MCGreeks:
    """Exact Greeks of the closed-form price by autodiff (+ gamma = ∂²/∂S₀²).

    Shares ``MCGreeks``' field conventions with the MC estimator because both
    differentiate the same 6-vector parametrization — the oracle the
    statistical tests compare against. ``dtype`` defaults to float64 when x64
    is enabled, else float32.
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    price_fn = make_analytic_price_fn(option=option, payoff=payoff, timesteps=timesteps)
    arr = contract.as_array(dtype)
    price, grad = jax.value_and_grad(price_fn)(arr)
    gamma = jax.grad(lambda c: jax.grad(price_fn)(c)[0])(arr)[0]
    return MCGreeks(
        price=float(price),
        by_field=dict(zip(_BS_FIELDS, (float(g) for g in grad))),
        gamma=float(gamma),
        engine=SimImplementation.XLA,
    )


__all__ = [
    "MCGreeks",
    "TermBucketGreeks",
    "term_bucket_greeks",
    "greeks_engine",
    "knock_in_price",
    "OptionSide",
    "analytic_greeks",
    "bump_greeks",
    "make_analytic_price_fn",
    "make_bump_greeks_fn",
    "make_mc_greeks_fn",
    "make_mc_price_fn",
    "mc_greeks",
]
