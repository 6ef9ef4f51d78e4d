"""GBM Monte-Carlo engine — the compute core, JAX-native.

Capability parity with the reference's Numba-CUDA engine
(``/root/reference/src/spectralmc/gbm.py:77-530``): ``SimulationParams`` with
the same workload shape (timesteps × network_size × batches_per_mc_run), the
log-Euler / Euler-with-reflection schemes, optional forward normalization,
discounted put/call payoff vectors + host prices, and a deterministic
``snapshot()`` capturing the RNG skip for bit-exact resume.

JAX-first redesign (vs the reference's 1-CUDA-thread-per-path kernel that
materializes the full ``[timesteps, paths]`` normals matrix in HBM):

* **No normals matrix.** ``lax.scan`` walks timesteps carrying only the
  ``[paths]`` state vector; each step's normals come from a counter-derived
  threefry key. HBM traffic drops from O(timesteps·paths) to O(paths).
* **Stateless resume.** The cuRAND skip bookkeeping
  (reference async_normals.py:319-321, gbm.py:332-339) becomes a single
  integer draw counter folded into the key.
* **Terminal-only normalization.** The reference rescales every time-row so
  its mean matches the analytic forward (gbm.py:433-440) *after* simulation —
  rows don't feed back, and pricing consumes only the terminal row, so
  normalizing the terminal row alone is price-equivalent. ``simulate_paths``
  (test/parity path) still materializes and normalizes all rows.
* A fused Pallas kernel with in-kernel RNG lives in ``gbm_pallas.py`` behind
  the same function signature.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
from pydantic import BaseModel, ConfigDict

from spectralmc_tpu.core.errors.gbm import (
    GBMError,
    InvalidContract,
    InvalidSimulationParams,
    MemoryLimitExceeded,
)
from spectralmc_tpu.ops.basket import BasketCombine, BasketSpec
from spectralmc_tpu.core.precision import Precision
from spectralmc_tpu.core.result import Failure, Result, Success

# Same config-time guardrails as the reference (gbm.py:106-137).
MAX_TOTAL_PATHS_F32 = 1_000_000_000
MAX_TOTAL_PATHS_F64 = 500_000_000


class PathScheme(enum.Enum):
    LOG_EULER = "log_euler"
    EULER = "euler"  # simple Euler with reflection |X| (reference gbm.py:251-257)


class ForwardNormalization(enum.Enum):
    NONE = "none"
    MEAN = "mean"  # rescale so the path mean matches the analytic forward


class PayoffKind(enum.Enum):
    """What the option pays on — the 'underlier' the spectrum is learned over.

    TERMINAL reproduces the reference exactly (European put/call on S_T).
    The Asian kinds are an extension with no reference counterpart: they pay
    on the discrete average over the monitoring grid t_1..t_N (the timestep
    grid), exercising the path-dependent capability the timestep walk exists
    for. ASIAN_GEOMETRIC has a closed form under the log-Euler scheme
    (ops/analytic.py::geometric_asian_price) and anchors the statistical
    gates; ASIAN_ARITHMETIC is the practically-traded variant.

    The BARRIER kinds are knockouts monitored on the same discrete grid:
    the path (the basket value, for baskets) crossing
    ``barrier_rel × spot`` at any t_i kills the payoff. Knocked paths emit
    underlier = strike, which zeroes BOTH vanilla payoffs in
    ``terminal_to_prices`` — so the same payoff pipeline prices knockouts
    (knock-ins: ``ops/greeks.py::knock_in_price`` computes in = vanilla −
    out under common random numbers). The oracle is
    ``ops/analytic.py::discrete_barrier_price`` — backward induction with
    exact per-step lognormal transitions, so it shares the simulator's
    discrete monitoring (no continuity-correction slop). No closed-form
    E[underlier]: MEAN normalization and call-via-parity are gated off
    (barrier options have no put-call parity anyway).
    """

    TERMINAL = "terminal"
    ASIAN_ARITHMETIC = "asian_arithmetic"
    ASIAN_GEOMETRIC = "asian_geometric"
    BARRIER_UP_OUT = "barrier_up_out"
    BARRIER_DOWN_OUT = "barrier_down_out"
    # Cash-or-nothing digitals, one unit of cash, as a synthetic underlier
    #     u = K + sign(S_T − K)
    # so the vanilla channels price BOTH digitals in one pass:
    # df·max(K−u,0) = df·1{S_T<K} (digital put), df·max(u−K,0) =
    # df·1{S_T>K} (digital call). S_T is the dynamics' terminal value (the
    # basket combine for baskets), drawn from the SAME bit stream as
    # TERMINAL — digital-vs-vanilla identities hold under common random
    # numbers, and every engine/sampling/term combination is inherited.
    # E[u] = K + 2·P(S_T>K) − 1 is closed-form exactly where the discrete
    # terminal law is known (GBM flat/curved: ops/analytic.py::digital_price;
    # Merton: exact series — so call-via-parity works there), but MEAN
    # normalization is gated off regardless: multiplicative rescaling of a
    # two-point ±1 encoding would corrupt the indicator, not recenter it.
    # IPA Greeks are refused (a.e.-zero pathwise derivative, like the
    # knockouts) — ``ops/greeks.py::bump_greeks`` covers digitals.
    DIGITAL = "digital"
    # Lookbacks on the running extreme over the monitor grid t_0..t_N
    # (t_0 INCLUDED — M ≥ S_0, m ≤ S_0). Named by the traded product; the
    # learned put channel carries it via a synthetic underlier (the
    # American precedent: encode so df·max(K−u,0) IS the product):
    #   LOOKBACK_FIXED_CALL  pays (M−K)+        u = 2K − M   (strike
    #     reflection: max(K−u,0) = max(M−K,0))
    #   LOOKBACK_FIXED_PUT   pays (K−m)+        u = m        (natural)
    #   LOOKBACK_FLOAT_PUT   pays M − S_T ≥ 0   u = K − (M − S_T)
    #   LOOKBACK_FLOAT_CALL  pays S_T − m ≥ 0   u = K − (S_T − m)
    # The call channel reports NaN (E[extreme] has no closed form on a
    # discrete grid, so no parity route; the float payoffs are certain —
    # their "call" channel is identically zero by construction). Oracle:
    # ``ops/analytic.py::lookback_price`` — barrier-survival integration
    # with the simulator's exact discrete monitoring (and, for geometric
    # baskets, at the effective-GBM parameters — ln B is itself a GBM).
    # IPA Greeks are VALID (running extremes are a.e. differentiable,
    # like the Asian average) — mc_greeks works unchanged.
    LOOKBACK_FIXED_CALL = "lookback_fixed_call"
    LOOKBACK_FIXED_PUT = "lookback_fixed_put"
    LOOKBACK_FLOAT_CALL = "lookback_float_call"
    LOOKBACK_FLOAT_PUT = "lookback_float_put"
    # Early exercise on the timestep grid (Bermudan → American as the grid
    # refines) via Longstaff–Schwartz regression MC (ops/american.py). The
    # per-path discounted cashflow cf is re-encoded as a SYNTHETIC underlier
    #     u = strike − cf / df          (df = e^{−r·maturity})
    # so the standard put-payoff pipeline df·max(strike − u, 0) reproduces cf
    # exactly for BOTH sides — the spectrum, the fused/sharded train steps and
    # the IFFT predictor all work unchanged. The learned channel is the
    # configured side's American price; the other side has no parity route
    # (early exercise breaks put-call parity), so it reports NaN.
    # ALL four dynamics (the Heston regression adds variance basis terms,
    # the arithmetic basket a dispersion term; Merton/geometric-basket spots
    # are Markov so the plain basis is exact state); no closed-form
    # E[underlier] (MEAN normalization gated off). Oracles:
    # ops/american.py::bermudan_tree_price (GBM, and geometric baskets via
    # the effective-GBM mapping), the q=0/r=0 no-early-exercise identities
    # vs heston_call_price / merton_call_price / the same-stream European.
    AMERICAN_PUT = "american_put"
    AMERICAN_CALL = "american_call"
    # Realized variance over the monitor grid:
    #     u = RV = (1/T) · Σ_{i=1..N} (ln(S_i/S_{i-1}))²
    # (annualized; for baskets the increments of the BASKET value). The
    # strike field carries the variance strike K in vol² units, so the two
    # channels are the traded variance options — put = df·max(K−RV,0)
    # (variance floor), call = df·max(RV−K,0) (variance cap) — and the payer
    # variance-swap leg is call − put = df·(E[RV] − K), delivered exactly by
    # call-via-parity wherever E[RV] has a closed form: GBM (flat AND curved
    # terms — per-step second moments are exact under log-Euler), Merton
    # (exact transitions), geometric baskets (ln B is an effective GBM).
    # Heston's full-truncation E[v⁺] and the arithmetic basket's
    # log-increments have no closed form (parity and MEAN gated off there).
    # Under flat log-Euler GBM the whole DISTRIBUTION is known:
    # RV ~ (v²dt/T)·χ'²(N, λ=N·a²/(v²dt)), a = (r−q−v²/2)dt — a noncentral
    # chi-square, so both channels have an exact discrete-grid oracle
    # (ops/analytic.py::variance_option_price). IPA Greeks are VALID (RV is
    # smooth in vol/rate; its pathwise delta is identically 0 under
    # log-Euler — the true model delta of a variance swap). MEAN
    # normalization is multiplicative on a positive underlier and allowed
    # exactly where E[RV] is closed-form.
    VARIANCE_SWAP = "variance_swap"
    # Forward-start (strike-setting) options: the strike fixes at grid date
    # t_m = m·dt (m = ``SimulationParams.forward_start_step``, 1 ≤ m < N)
    # as a multiple of the then-spot. The underlier re-bases the ratio to
    # today's spot:
    #     u = spot · S_T / S_m          (B₀·B_T/B_m for baskets)
    # so the put channel df·max(K − u, 0) = spot·df·max(k − S_T/S_m, 0) is
    # the traded forward-start put with relative strike k = K/spot, and the
    # call channel its twin. E[u] = spot·E[S_T/S_m] is EXACT for every
    # dynamics whose discounted spot is a per-step martingale — GBM (flat
    # and curved), Heston (the full-truncation step preserves it) and
    # Merton (the compensator) — so parity and MEAN normalization work for
    # all three; only the arithmetic basket (a ratio of weighted sums) has
    # no closed form. Under log-Euler GBM the ratio S_T/S_m is lognormal in
    # the TAIL increments alone, giving an exact discrete-grid oracle
    # (ops/analytic.py::forward_start_price) — and a state-free simulation:
    # GBM/Merton/geometric baskets integrate only steps m..N−1, Heston and
    # arithmetic baskets walk the full path and capture state at t_m. IPA
    # Greeks are VALID; the payoff is homogeneous of degree 1 in (spot,
    # strike), so spot·Δ + K·∂K = price exactly (Euler's identity — gated in
    # tests), and vol buckets before t_m carry ZERO vega under GBM (the
    # ratio never sees them).
    FORWARD_START = "forward_start"
    # Cliquet (ratchet): the sum of locally capped/floored period returns
    # over the reset grid t_0, t_k, t_2k, ... (k = ``cliquet_reset_every``
    # steps per period, k | timesteps, ≥ 2 periods):
    #     u = Σ_j clip(S_{t_{j+1}·k}/S_{t_j·k} − 1, floor, cap)
    # The strike field carries the guarantee level K in RETURN units
    # (like VARIANCE_SWAP's vol² strike), so the two channels are the traded
    # structures — call = df·max(u − K, 0) is the globally-floored cliquet's
    # option leg (the classic minimum-coupon cliquet pays df·(K + call));
    # put = df·max(K − u, 0) is the shortfall leg. Simulation is state-free
    # in ln S under both schemes (each period return is a product of
    # per-step growth factors), so the scan carries only the running period
    # log-return and the clipped accumulator. E[u] = Σ_j E[clip(R_j)] is
    # closed-form wherever the per-period return law is known: GBM (flat AND
    # curved — each period is lognormal in its own segment sums), Merton
    # (Poisson mixture of lognormals → series), geometric baskets (the
    # effective GBM); Heston's conditional period law and the arithmetic
    # basket's have none (parity and MEAN gated off there). MEAN
    # normalization is additionally gated off for ALL dynamics: u is a sum
    # of CLIPPED returns (can be ≤ 0, and a multiplicative rescale would
    # move returns through the clip levels — the digital precedent, not the
    # variance-swap one). Under flat log-Euler GBM the periods are iid, so
    # the whole distribution is a P-fold convolution of a known mixed law —
    # an exact discrete-grid oracle (ops/analytic.py::cliquet_price,
    # lattice-convolution). IPA Greeks are VALID (clip is a.e.
    # differentiable; the pathwise spot-delta is identically 0 under
    # log-Euler, like VARIANCE_SWAP — returns are state-free).
    CLIQUET = "cliquet"


BARRIER_PAYOFFS = frozenset({PayoffKind.BARRIER_UP_OUT, PayoffKind.BARRIER_DOWN_OUT})
AMERICAN_PAYOFFS = frozenset({PayoffKind.AMERICAN_PUT, PayoffKind.AMERICAN_CALL})
LOOKBACK_PAYOFFS = frozenset(
    {
        PayoffKind.LOOKBACK_FIXED_CALL,
        PayoffKind.LOOKBACK_FIXED_PUT,
        PayoffKind.LOOKBACK_FLOAT_CALL,
        PayoffKind.LOOKBACK_FLOAT_PUT,
    }
)
# kinds whose extreme is the running MAX (the others track the running MIN)
LOOKBACK_MAX_PAYOFFS = frozenset(
    {PayoffKind.LOOKBACK_FIXED_CALL, PayoffKind.LOOKBACK_FLOAT_PUT}
)


def lookback_underlier(
    payoff: PayoffKind, strike: jax.Array, extreme: jax.Array, terminal: jax.Array
) -> jax.Array:
    """The lookback kinds' synthetic underlier (PayoffKind docstring).

    ``extreme``/``terminal`` in LINEAR price space; shared by the XLA scans
    and the Pallas kernel epilogues so the encoding cannot desync."""
    if payoff == PayoffKind.LOOKBACK_FIXED_CALL:
        return 2.0 * strike - extreme
    if payoff == PayoffKind.LOOKBACK_FIXED_PUT:
        return extreme
    if payoff == PayoffKind.LOOKBACK_FLOAT_PUT:
        return strike - (extreme - terminal)
    assert payoff == PayoffKind.LOOKBACK_FLOAT_CALL
    return strike - (terminal - extreme)


class ModelKind(enum.Enum):
    """Which dynamics the MC engine simulates (the model-family axis).

    GBM reproduces the reference (its only dynamics); HESTON is the
    stochastic-volatility extension (ops/heston.py); BASKET_GBM is the
    multi-asset correlated extension (ops/basket.py, requires
    ``SimulationParams.basket``); MERTON_JUMP is the jump-diffusion
    extension (ops/merton.py, exact per-step transition sampling)."""

    GBM = "gbm"
    HESTON = "heston"
    BASKET_GBM = "basket_gbm"
    MERTON_JUMP = "merton_jump"


class SimImplementation(enum.Enum):
    XLA = "xla"  # lax.scan reference implementation
    PALLAS = "pallas"  # fused RNG+step kernel (gbm_pallas.py)


class SamplingKind(enum.Enum):
    """Where the path increments come from (extension; no reference counterpart
    — the reference's path normals are always pseudo-random cuRAND draws,
    async_normals.py:213-217; its only low-discrepancy use is contract
    sampling).

    PSEUDO: counter-keyed threefry normals (the reference-equivalent stream).
    SOBOL_BB: randomized quasi-Monte-Carlo — one scrambled Sobol point per
    path, Brownian-bridge variance ordering applied as a single orthogonal
    matmul (ops/qmc.py). Upgrades the error rate from O(N^-1/2) toward
    O(N^-1) on smooth payoffs (~50x RMSE reduction measured at 4096 paths,
    tests/test_qmc.py). Checkpointed: it is a different bit stream.
    """

    PSEUDO = "pseudo"
    SOBOL_BB = "sobol_bb"


class TermStructure(BaseModel):
    """Piecewise-constant relative curves over the simulation grid (extension;
    the reference's market data is flat scalars, gbm.py:77-103).

    Each shape is a per-step multiplier on the corresponding CONTRACT field:
    during step ``t`` (covering ``(t·dt, (t+1)·dt]``) the instantaneous
    parameters are ``vol·vol_shape[t]``, ``rate·rate_shape[t]`` and
    ``div_yield·div_shape[t]``. An empty tuple means flat (all ones). The
    contract scalars stay the Sobol-sampled training features; the curves are
    desk configuration — checkpointed with ``SimulationParams`` (they change
    the trained distribution, not the bit stream: the normals keying is
    untouched).

    The terminal distribution stays exactly lognormal, so the Black oracle
    holds with the effective parameters ``vol_eff = vol·sqrt(mean(vs²))``,
    ``rate_eff = rate·mean(rs)``, ``div_eff = div·mean(qs)``
    (``ops/analytic.py::term_effective_black``) — the curves are new exact
    oracle surface, not just new simulation surface.
    """

    model_config = ConfigDict(frozen=True, extra="forbid")

    vol_shape: tuple[float, ...] = ()
    rate_shape: tuple[float, ...] = ()
    div_shape: tuple[float, ...] = ()

    def is_flat(self) -> bool:
        return all(
            all(v == 1.0 for v in shape)
            for shape in (self.vol_shape, self.rate_shape, self.div_shape)
        )

    def n_steps(self) -> int | None:
        """The grid length implied by the non-empty shapes (None = all flat,
        equivalent to no term structure at any timestep count)."""
        for s in (self.vol_shape, self.rate_shape, self.div_shape):
            if s:
                return len(s)
        return None

    def shapes(self, timesteps: int) -> tuple[tuple[float, ...], ...]:
        """(vol, rate, div) shapes with empties expanded to flat ones."""
        flat = (1.0,) * timesteps
        return (
            self.vol_shape or flat,
            self.rate_shape or flat,
            self.div_shape or flat,
        )

    def effective_factors(self, timesteps: int) -> tuple[float, float, float]:
        """(RMS vol factor, mean rate factor, mean div factor) — the exact
        flat-equivalent multipliers for the terminal lognormal law."""
        vs, rs, qs = self.shapes(timesteps)
        n = float(timesteps)
        return (
            math.sqrt(sum(v * v for v in vs) / n),
            sum(rs) / n,
            sum(qs) / n,
        )


def validate_term_structure(
    term: TermStructure, *, timesteps: int
) -> Result[TermStructure, GBMError]:
    """Shape-length and positivity checks (Result-typed, like the other
    ``build_*`` validators)."""
    for name, shape in (
        ("vol_shape", term.vol_shape),
        ("rate_shape", term.rate_shape),
        ("div_shape", term.div_shape),
    ):
        if shape and len(shape) != timesteps:
            return Failure(
                InvalidSimulationParams(
                    field=f"term.{name}",
                    value=len(shape),
                    reason=f"length must equal timesteps ({timesteps})",
                )
            )
        if not all(math.isfinite(v) for v in shape):
            return Failure(
                InvalidSimulationParams(
                    field=f"term.{name}", value=shape, reason="entries must be finite"
                )
            )
    if any(v < 0.0 for v in term.vol_shape):
        return Failure(
            InvalidSimulationParams(
                field="term.vol_shape",
                value=term.vol_shape,
                reason="vol multipliers must be >= 0",
            )
        )
    if term.vol_shape and not any(v > 0.0 for v in term.vol_shape):
        return Failure(
            InvalidSimulationParams(
                field="term.vol_shape",
                value=term.vol_shape,
                reason="at least one step must have positive vol",
            )
        )
    return Success(term)


def bootstrap_vol_shape(
    quotes: tuple[tuple[int, float], ...],
    *,
    timesteps: int,
    reference_vol: float,
) -> Result[tuple[float, ...], GBMError]:
    """Strip a market term structure of implied vols into a ``vol_shape``.

    ``quotes`` are ``(grid_step k, implied_vol at t_k)`` pairs — the desk's
    expiry strip restricted to simulation dates. Piecewise-flat forward
    variance: steps in ``(k_{i-1}, k_i]`` get
    ``v² = (k_i σ_i² − k_{i-1} σ_{i-1}²) / (k_i − k_{i-1})`` — the unique
    piecewise-constant curve that reproduces every quote EXACTLY (the RMS of
    the returned shape over the first k_i steps, times ``reference_vol``, is
    σ_i to fp rounding). Beyond the last quote the curve extends flat.

    Fails loudly on a calendar-arbitrage strip (negative forward variance:
    ``k_i σ_i² < k_{i-1} σ_{i-1}²``) instead of emitting an imaginary vol —
    the term-structure analogue of the no-arbitrage NaN contract of
    ``ops/analytic.py::implied_vol``.
    """
    if reference_vol <= 0.0 or not math.isfinite(reference_vol):
        return Failure(
            InvalidSimulationParams(
                field="reference_vol", value=reference_vol, reason="must be > 0"
            )
        )
    if not quotes:
        return Failure(
            InvalidSimulationParams(field="quotes", value=(), reason="need >= 1 quote")
        )
    prev_k = 0
    prev_total_var = 0.0
    shape: list[float] = []
    for k, sigma in quotes:
        if not (0 < k <= timesteps):
            return Failure(
                InvalidSimulationParams(
                    field="quotes",
                    value=k,
                    reason=f"expiry step must be in [1, {timesteps}]",
                )
            )
        if k <= prev_k:
            return Failure(
                InvalidSimulationParams(
                    field="quotes", value=k, reason="expiry steps must be increasing"
                )
            )
        if sigma <= 0.0 or not math.isfinite(sigma):
            return Failure(
                InvalidSimulationParams(
                    field="quotes", value=sigma, reason="implied vols must be > 0"
                )
            )
        total_var = k * sigma * sigma  # in units of one grid step
        fwd_var = (total_var - prev_total_var) / (k - prev_k)
        if fwd_var < 0.0:
            return Failure(
                InvalidSimulationParams(
                    field="quotes",
                    value=(k, sigma),
                    reason="calendar arbitrage: total implied variance "
                    f"decreases at step {k} "
                    f"({total_var:.6g} < {prev_total_var:.6g})",
                )
            )
        shape.extend([math.sqrt(fwd_var) / reference_vol] * (k - prev_k))
        prev_k, prev_total_var = k, total_var
    if prev_k < timesteps:
        shape.extend([shape[-1]] * (timesteps - prev_k))
    return Success(tuple(shape))


class BlackScholesContract(BaseModel):
    """One European-option market scenario (parity: reference ``BlackScholes.Inputs``)."""

    model_config = ConfigDict(frozen=True, extra="forbid")

    spot: float
    strike: float
    maturity: float
    rate: float
    div_yield: float
    vol: float

    def as_array(self, dtype: jnp.dtype = jnp.float32) -> jax.Array:
        return jnp.array(
            [self.spot, self.strike, self.maturity, self.rate, self.div_yield, self.vol],
            dtype=dtype,
        )


CONTRACT_FIELDS: tuple[str, ...] = tuple(BlackScholesContract.model_fields.keys())
CONTRACT_DIM = len(CONTRACT_FIELDS)


def validate_contract(c: BlackScholesContract) -> Result[BlackScholesContract, GBMError]:
    for field in ("spot", "strike", "maturity", "vol"):
        value = getattr(c, field)
        if value <= 0.0:
            return Failure(InvalidContract(field=field, value=value, reason="must be positive"))
    return Success(c)


class SimulationParams(BaseModel):
    """Workload shape + determinism state (parity: reference gbm.py:77-103).

    ``total_paths = network_size * batches_per_mc_run``; the FFT length is
    ``network_size``. ``skip`` is the number of contract-simulations already
    drawn from the key stream (the checkpointed resume offset).
    ``threads_per_block`` has no counterpart — tiling is the compiler's
    job (Pallas block shapes are chosen in gbm_pallas.py).
    """

    model_config = ConfigDict(frozen=True, extra="forbid")

    timesteps: int
    network_size: int
    batches_per_mc_run: int
    mc_seed: int
    skip: int = 0
    precision: Precision = Precision.float32
    scheme: PathScheme = PathScheme.LOG_EULER
    normalization: ForwardNormalization = ForwardNormalization.MEAN
    implementation: SimImplementation = SimImplementation.XLA
    payoff: PayoffKind = PayoffKind.TERMINAL
    model: ModelKind = ModelKind.GBM
    # static basket structure; required iff model == BASKET_GBM
    basket: "BasketSpec | None" = None
    # knockout level as a multiple of spot; required iff payoff is a BARRIER
    # kind (>1 for UP_OUT, in (0,1) for DOWN_OUT)
    barrier_rel: float | None = None
    # antithetic variates: the second half of the MC rows mirrors the first
    # half's normals with flipped sign — unbiased, and variance-reducing for
    # monotone payoffs. Checkpointed (changes the bit stream when on);
    # requires an even batches_per_mc_run.
    antithetic: bool = False
    # Longstaff–Schwartz regression basis degree (polynomial in moneyness
    # S/K); meaningful only for the AMERICAN payoff kinds. Checkpointed: it
    # changes the exercise policy, hence the learned target distribution.
    lsmc_basis_degree: int = 5
    # Bermudan monitor grid: exercise allowed every k-th simulation date
    # (t_k, t_2k, ..., t_T; must divide timesteps). 1 = every date (the
    # American-limit default). Checkpointed for the same reason.
    lsmc_exercise_every: int = 1
    # bracket-midpoint cross-fitted LSMC: each path's cashflow averages the
    # classic in-sample recursion (look-ahead HIGH bias) and a 2-fold
    # out-of-sample recursion (half-sample policy LOW bias), cancelling most
    # of both in the training targets at full path count
    # (ops/american.py::_lsmc_backward cross_fit_mask notes). Default False
    # keeps every existing stream bit-identical. Checkpointed: it changes
    # the exercise policy, hence the target distribution.
    lsmc_cross_fit: bool = False
    # The fused Pallas LSMC backward this flag selected was removed; the
    # field stays so checkpoints that carry it still decode, and
    # build_simulation_params refuses True (the trainer's recorded
    # lsmc_backward_version turns a mid-stream resume into EngineMismatch).
    lsmc_fused_backward: bool = False
    # strike-setting grid index for the FORWARD_START payoff (the strike
    # fixes at t_m = forward_start_step·dt; 1 ≤ m < timesteps). Required iff
    # payoff == FORWARD_START. Checkpointed: it defines the product.
    forward_start_step: int | None = None
    # cliquet reset grid + local clip levels (see PayoffKind.CLIQUET).
    # Required iff payoff == CLIQUET: reset_every must divide timesteps with
    # ≥ 2 periods; floor ∈ (−1, cap), cap > floor. Checkpointed: they define
    # the product.
    cliquet_reset_every: int | None = None
    cliquet_floor: float | None = None
    cliquet_cap: float | None = None
    # path-increment source (see SamplingKind); SOBOL_BB is a different bit
    # stream, so it is checkpointed and routes to the XLA engine
    sampling: SamplingKind = SamplingKind.PSEUDO
    # piecewise-constant vol/rate/div curves over the step grid (GBM model
    # only); checkpointed — the curves define the trained distribution. The
    # RNG keying is untouched, but the engine routes to XLA (the Pallas GBM
    # kernel computes flat per-step drift in-register).
    term: TermStructure | None = None

    @property
    def total_paths(self) -> int:
        return self.network_size * self.batches_per_mc_run


def build_simulation_params(**kwargs: Any) -> Result[SimulationParams, GBMError]:
    """Validated constructor (parity: reference ``build_simulation_params``)."""
    try:
        params = SimulationParams(**kwargs)
    except Exception as exc:  # pydantic ValidationError
        return Failure(InvalidSimulationParams(field="<model>", value=kwargs, reason=str(exc)))
    if params.lsmc_fused_backward:
        return Failure(
            InvalidSimulationParams(
                field="lsmc_fused_backward",
                value=True,
                reason="the fused Pallas LSMC backward was removed; every "
                "American payoff runs the shared XLA backward "
                "(ops/american.py) — leave lsmc_fused_backward unset",
            )
        )
    for field in ("timesteps", "network_size", "batches_per_mc_run"):
        if getattr(params, field) <= 0:
            return Failure(
                InvalidSimulationParams(
                    field=field, value=getattr(params, field), reason="must be positive"
                )
            )
    if params.mc_seed < 0:
        return Failure(
            InvalidSimulationParams(field="mc_seed", value=params.mc_seed, reason="must be >= 0")
        )
    if params.skip < 0:
        return Failure(
            InvalidSimulationParams(field="skip", value=params.skip, reason="must be >= 0")
        )
    if params.precision.is_complex():
        return Failure(
            InvalidSimulationParams(
                field="precision", value=params.precision.value, reason="MC dtype must be real"
            )
        )
    limit = MAX_TOTAL_PATHS_F64 if params.precision == Precision.float64 else MAX_TOTAL_PATHS_F32
    if params.total_paths > limit:
        return Failure(
            MemoryLimitExceeded(
                total_paths=params.total_paths,
                limit=limit,
                dtype=params.precision.value,
                reason="config-time path guardrail",
            )
        )
    checked = params.precision.validate_available()
    if isinstance(checked, Failure):
        return Failure(
            InvalidSimulationParams(
                field="precision", value=params.precision.value, reason=checked.error.reason
            )
        )
    if params.model == ModelKind.BASKET_GBM:
        if params.basket is None:
            return Failure(
                InvalidSimulationParams(
                    field="basket", value=None, reason="model='basket_gbm' requires a BasketSpec"
                )
            )
        if params.scheme != PathScheme.LOG_EULER:
            return Failure(
                InvalidSimulationParams(
                    field="scheme",
                    value=params.scheme.value,
                    reason="basket dynamics are log-Euler only",
                )
            )
    elif params.basket is not None:
        return Failure(
            InvalidSimulationParams(
                field="basket",
                value=params.basket,
                reason=f"model={params.model.value!r} takes no BasketSpec",
            )
        )
    if params.model == ModelKind.MERTON_JUMP and params.scheme != PathScheme.LOG_EULER:
        return Failure(
            InvalidSimulationParams(
                field="scheme",
                value=params.scheme.value,
                reason="Merton jump-diffusion samples the exact log-space "
                "transition; only log-Euler is defined",
            )
        )
    if params.payoff in BARRIER_PAYOFFS:
        if params.barrier_rel is None:
            return Failure(
                InvalidSimulationParams(
                    field="barrier_rel",
                    value=None,
                    reason=f"payoff={params.payoff.value!r} requires barrier_rel",
                )
            )
        if params.payoff == PayoffKind.BARRIER_UP_OUT and params.barrier_rel <= 1.0:
            return Failure(
                InvalidSimulationParams(
                    field="barrier_rel",
                    value=params.barrier_rel,
                    reason="up-and-out barrier must be > 1x spot",
                )
            )
        if params.payoff == PayoffKind.BARRIER_DOWN_OUT and not (
            0.0 < params.barrier_rel < 1.0
        ):
            return Failure(
                InvalidSimulationParams(
                    field="barrier_rel",
                    value=params.barrier_rel,
                    reason="down-and-out barrier must be in (0, 1)x spot",
                )
            )
    elif params.barrier_rel is not None:
        return Failure(
            InvalidSimulationParams(
                field="barrier_rel",
                value=params.barrier_rel,
                reason=f"payoff={params.payoff.value!r} takes no barrier",
            )
        )
    if params.payoff == PayoffKind.FORWARD_START:
        if params.forward_start_step is None:
            return Failure(
                InvalidSimulationParams(
                    field="forward_start_step",
                    value=None,
                    reason="payoff='forward_start' requires forward_start_step",
                )
            )
        if not (1 <= params.forward_start_step < params.timesteps):
            return Failure(
                InvalidSimulationParams(
                    field="forward_start_step",
                    value=params.forward_start_step,
                    reason="strike-setting date must be an interior grid "
                    "index (1 <= m < timesteps)",
                )
            )
    elif params.forward_start_step is not None:
        return Failure(
            InvalidSimulationParams(
                field="forward_start_step",
                value=params.forward_start_step,
                reason=f"payoff={params.payoff.value!r} takes no "
                "strike-setting date",
            )
        )
    if params.payoff == PayoffKind.CLIQUET:
        if (
            params.cliquet_reset_every is None
            or params.cliquet_floor is None
            or params.cliquet_cap is None
        ):
            return Failure(
                InvalidSimulationParams(
                    field="cliquet_reset_every",
                    value=None,
                    reason="payoff='cliquet' requires cliquet_reset_every, "
                    "cliquet_floor and cliquet_cap",
                )
            )
        if params.cliquet_reset_every < 1 or (
            params.timesteps % params.cliquet_reset_every
        ):
            return Failure(
                InvalidSimulationParams(
                    field="cliquet_reset_every",
                    value=params.cliquet_reset_every,
                    reason="must be >= 1 and divide timesteps (maturity is "
                    "always a reset date)",
                )
            )
        if params.timesteps // params.cliquet_reset_every < 2:
            return Failure(
                InvalidSimulationParams(
                    field="cliquet_reset_every",
                    value=params.cliquet_reset_every,
                    reason="a cliquet needs >= 2 reset periods (one period "
                    "is a clipped forward — use payoff='terminal')",
                )
            )
        if not (-1.0 < params.cliquet_floor < params.cliquet_cap):
            return Failure(
                InvalidSimulationParams(
                    field="cliquet_floor",
                    value=params.cliquet_floor,
                    reason="need -1 < floor < cap (a period return cannot "
                    "fall below -100%)",
                )
            )
    elif (
        params.cliquet_reset_every is not None
        or params.cliquet_floor is not None
        or params.cliquet_cap is not None
    ):
        return Failure(
            InvalidSimulationParams(
                field="cliquet_reset_every",
                value=params.cliquet_reset_every,
                reason=f"payoff={params.payoff.value!r} takes no cliquet "
                "reset grid or clip levels",
            )
        )
    if params.payoff in AMERICAN_PAYOFFS:
        if params.scheme != PathScheme.LOG_EULER:
            return Failure(
                InvalidSimulationParams(
                    field="scheme",
                    value=params.scheme.value,
                    reason="LSMC early exercise is log-Euler only",
                )
            )
        if not (1 <= params.lsmc_basis_degree <= 8):
            return Failure(
                InvalidSimulationParams(
                    field="lsmc_basis_degree",
                    value=params.lsmc_basis_degree,
                    reason="must be in [1, 8]",
                )
            )
        if params.lsmc_exercise_every < 1 or (
            params.timesteps % params.lsmc_exercise_every
        ):
            return Failure(
                InvalidSimulationParams(
                    field="lsmc_exercise_every",
                    value=params.lsmc_exercise_every,
                    reason="must be >= 1 and divide timesteps (maturity is "
                    "always a monitor date)",
                )
            )
        if params.timesteps // params.lsmc_exercise_every < 2:
            return Failure(
                InvalidSimulationParams(
                    field="timesteps",
                    value=params.timesteps,
                    reason="early exercise needs >= 2 monitor dates",
                )
            )
        if params.lsmc_cross_fit and params.network_size < 2:
            return Failure(
                InvalidSimulationParams(
                    field="lsmc_cross_fit",
                    value=True,
                    reason="cross-fitting splits the path columns in half; "
                    "network_size must be >= 2",
                )
            )
    elif params.lsmc_cross_fit:
        return Failure(
            InvalidSimulationParams(
                field="lsmc_cross_fit",
                value=True,
                reason=f"payoff={params.payoff.value!r} has no LSMC "
                "regression to cross-fit",
            )
        )
    if params.term is not None:
        if params.model == ModelKind.HESTON and any(
            v != 1.0 for v in params.term.vol_shape
        ):
            return Failure(
                InvalidSimulationParams(
                    field="term",
                    value="vol_shape",
                    reason="Heston has no deterministic vol curve — its "
                    "instantaneous vol IS the variance process (v0/kappa/"
                    "theta/xi contract fields); rate_shape/div_shape curves "
                    "are supported",
                )
            )
        if (
            params.model != ModelKind.GBM
            and params.payoff in AMERICAN_PAYOFFS
            and not params.term.is_flat()
        ):
            return Failure(
                InvalidSimulationParams(
                    field="term",
                    value=params.model.value,
                    reason="LSMC early exercise under term structures is "
                    "supported for GBM dynamics only (the curved-coefficient "
                    "lattice oracle and per-segment discount backward exist "
                    "for the single-factor lognormal family)",
                )
            )
        checked_term = validate_term_structure(params.term, timesteps=params.timesteps)
        if isinstance(checked_term, Failure):
            return checked_term  # type: ignore[return-value]
    if params.antithetic and params.batches_per_mc_run % 2:
        return Failure(
            InvalidSimulationParams(
                field="antithetic",
                value=params.batches_per_mc_run,
                reason="antithetic pairing needs an even batches_per_mc_run",
            )
        )
    if params.sampling == SamplingKind.SOBOL_BB:
        if params.payoff in AMERICAN_PAYOFFS:
            return Failure(
                InvalidSimulationParams(
                    field="sampling",
                    value=params.sampling.value,
                    reason="LSMC early exercise draws its own pseudo stream; "
                    "QMC applies to the path-independent payoff kinds",
                )
            )
        if params.antithetic:
            return Failure(
                InvalidSimulationParams(
                    field="antithetic",
                    value=True,
                    reason="the scrambled Sobol net is already stratified; "
                    "antithetic mirroring would break its digital-shift "
                    "randomization (choose one variance-reduction scheme)",
                )
            )
    if (
        params.normalization == ForwardNormalization.MEAN
        and params.payoff == PayoffKind.DIGITAL
    ):
        return Failure(
            InvalidSimulationParams(
                field="normalization",
                value=params.normalization.value,
                reason="the digital ±1 underlier encoding is not "
                "scale-equivariant: multiplicative mean rescaling would "
                "corrupt the indicator; use normalization='none'",
            )
        )
    if (
        params.normalization == ForwardNormalization.MEAN
        and params.payoff == PayoffKind.CLIQUET
    ):
        return Failure(
            InvalidSimulationParams(
                field="normalization",
                value=params.normalization.value,
                reason="the cliquet sum of clipped returns is not "
                "scale-equivariant: multiplicative mean rescaling would "
                "move returns through the clip levels; use "
                "normalization='none'",
            )
        )
    if (
        params.normalization == ForwardNormalization.MEAN
        and not has_closed_form_mean(
            params.model, params.payoff, combine=params.basket.combine if params.basket else None
        )
    ):
        return Failure(
            InvalidSimulationParams(
                field="normalization",
                value=params.normalization.value,
                reason=f"E[underlier] has no closed form for {params.model.value}/"
                f"{params.payoff.value}; use normalization='none'",
            )
        )
    return Success(params)


def has_closed_form_mean(
    model: ModelKind, payoff: PayoffKind, *, combine: BasketCombine | None = None
) -> bool:
    """Whether analytic E[underlier] exists for this (dynamics, payoff) pair.

    A property of the config, not of runtime data: GBM has closed forms for
    all payoff kinds (``expected_underlier_mean``); Heston's discounted spot
    is a martingale so TERMINAL/ASIAN_ARITHMETIC reuse them, but the
    geometric average's mean has no usable closed form
    (``heston_expected_underlier_mean`` returns None there). Baskets: the
    geometric combine is lognormal (all payoffs closed-form); the arithmetic
    combine loses only its geometric time-average. Gates MEAN normalization
    at build time and call-via-parity at predict time.
    """
    if payoff in BARRIER_PAYOFFS:
        # the knocked-out underlier's mean has no closed form for any model,
        # and barrier options have no put-call parity regardless
        return False
    if payoff in AMERICAN_PAYOFFS:
        # the synthetic LSMC underlier's mean is strike − price/df — exactly
        # the unknown being estimated; and early exercise breaks parity anyway
        return False
    if payoff in LOOKBACK_PAYOFFS:
        # E[running extreme] over a discrete grid has no closed form (the
        # continuous-monitoring formulas carry O(sqrt(dt)) monitoring bias)
        return False
    if payoff == PayoffKind.DIGITAL:
        # E[u] = K + 2·P(S_T>K) − 1 needs the exact discrete terminal law:
        # GBM (flat or curves) and Merton (exact transitions → series) have
        # it; the Heston Euler scheme's P(S_T>K) and the arithmetic basket's
        # do not (the continuous-Heston P2 would import discretization bias)
        if model == ModelKind.HESTON:
            return False
        if model == ModelKind.BASKET_GBM and combine == BasketCombine.ARITHMETIC:
            return False
        return True
    if payoff == PayoffKind.VARIANCE_SWAP:
        # E[RV] needs exact per-step second moments of the log-increments:
        # GBM (flat or curved) and Merton (exact transitions) have them, and
        # the geometric basket's ln B is an effective GBM; Heston's
        # full-truncation E[v⁺] and the arithmetic basket's log-increments
        # have no closed form
        if model == ModelKind.HESTON:
            return False
        if model == ModelKind.BASKET_GBM and combine == BasketCombine.ARITHMETIC:
            return False
        return True
    if payoff == PayoffKind.FORWARD_START:
        # E[S_T/S_m] = e^{(r−q)(T−t_m)} wherever the discounted spot is a
        # per-step martingale — GBM, Heston (full truncation preserves it)
        # and Merton (the compensator); the arithmetic basket's ratio of
        # weighted sums has no closed form
        return not (model == ModelKind.BASKET_GBM and combine == BasketCombine.ARITHMETIC)
    if payoff == PayoffKind.CLIQUET:
        # E[Σ clip(R_j)] needs each period return's exact law: GBM (flat or
        # curved — lognormal per segment), Merton (Poisson mixture series),
        # geometric baskets (effective GBM). Heston's period return
        # conditions on the variance path and the arithmetic basket's is a
        # ratio of weighted sums — no closed form. (MEAN normalization is
        # gated off for ALL dynamics separately: clipping is not
        # scale-equivariant; this gate feeds call-via-parity only.)
        if model == ModelKind.HESTON:
            return False
        if model == ModelKind.BASKET_GBM and combine == BasketCombine.ARITHMETIC:
            return False
        return True
    if model in (ModelKind.HESTON, ModelKind.MERTON_JUMP):
        # both keep the discounted spot a martingale (Heston by construction,
        # Merton via the -lam*m compensator) but lose the geometric average
        return payoff != PayoffKind.ASIAN_GEOMETRIC
    if model == ModelKind.BASKET_GBM and combine == BasketCombine.ARITHMETIC:
        return payoff != PayoffKind.ASIAN_GEOMETRIC
    return True


def resolve_implementation(params: SimulationParams, *, rows: int | None = None) -> SimImplementation:
    """The engine that will ACTUALLY execute for these params on this backend.

    The Pallas kernels cannot run every dtype/shape/backend (their wrappers
    refuse), and the two engines draw from different bit streams (the
    kernels' in-kernel threefry layout vs the XLA fold_in stream), so which
    one ran is checkpoint-relevant state. Callers that record or resume determinism state must resolve the
    requested implementation through this function (single source of truth:
    ``gbm_pallas.pallas_supported``). ``rows`` is the per-shard row count
    when the MC batch is sharded over a mesh paths axis.
    """
    if params.implementation != SimImplementation.PALLAS:
        return params.implementation
    if params.payoff in AMERICAN_PAYOFFS:
        if params.term is not None and not params.term.is_flat():
            # the monitor-row kernels take no per-step coefficient tables;
            # curved-term LSMC runs the XLA forward (same threefry stream)
            return SimImplementation.XLA
        # The Pallas engine for LSMC is a monitor-row kernel per dynamics
        # (fused forward emitting the exercise-date state) + the XLA
        # backward induction over the emitted rows.
        from spectralmc_tpu.ops.gbm_pallas import pallas_american_supported

        if pallas_american_supported(
            dtype=params.precision.to_jnp(),
            rows=params.batches_per_mc_run if rows is None else rows,
            cols=params.network_size,
            timesteps=params.timesteps,
            exercise_every=params.lsmc_exercise_every,
        ):
            return SimImplementation.PALLAS
        return SimImplementation.XLA
    if params.sampling == SamplingKind.SOBOL_BB:
        # the Brownian-bridge contraction is a [T, T] x [T, paths] matmul —
        # matmul-shaped work the XLA engine expresses directly; the Pallas
        # kernels' in-register streaming RNG has no Sobol counterpart
        return SimImplementation.XLA
    if params.payoff == PayoffKind.CLIQUET:
        # GBM cliquets under flat log-Euler take the per-period kernel
        # (stream key ``gbm_cliquet``): each reset period's log-return is an
        # exact Gaussian sum, so the kernel draws ONE normal per period —
        # reset_every× fewer draws for the identical distribution. Other
        # dynamics carry period-start state (Heston/basket) or per-step jump
        # semantics (Merton), curved terms break the aggregation, and EULER
        # ratios are not Gaussian sums — all keep the XLA scan.
        if (
            params.model != ModelKind.GBM
            or params.scheme != PathScheme.LOG_EULER
            or (params.term is not None and not params.term.is_flat())
        ):
            return SimImplementation.XLA
        from spectralmc_tpu.ops.gbm_pallas import pallas_supported as _ps_cq

        if _ps_cq(
            dtype=params.precision.to_jnp(),
            rows=params.batches_per_mc_run if rows is None else rows,
            cols=params.network_size,
        ):
            return SimImplementation.PALLAS
        return SimImplementation.XLA
    if params.term is not None and not params.term.is_flat():
        # genuinely curved markets run the term kernel (per-step
        # coefficient table, stream key "gbm_term") at supported shapes;
        # the reflection-Euler compatibility scheme stays on XLA, and the
        # non-GBM family kernels take no coefficient tables — curved
        # Heston/Merton/basket sims run their XLA scans (round 4). An
        # exactly-flat term is the same program as no term and falls
        # through to the flat-kernel logic below.
        if params.scheme != PathScheme.LOG_EULER or params.model != ModelKind.GBM:
            return SimImplementation.XLA
        from spectralmc_tpu.ops.gbm_pallas import pallas_supported as _ps

        if _ps(
            dtype=params.precision.to_jnp(),
            rows=params.batches_per_mc_run if rows is None else rows,
            cols=params.network_size,
        ):
            return SimImplementation.PALLAS
        return SimImplementation.XLA
    from spectralmc_tpu.ops.gbm_pallas import pallas_supported

    effective_rows = params.batches_per_mc_run if rows is None else rows
    if pallas_supported(
        dtype=params.precision.to_jnp(), rows=effective_rows, cols=params.network_size
    ):
        return SimImplementation.PALLAS
    return SimImplementation.XLA


# --------------------------------------------------------------------------
# Pure simulation functions (jit-safe; static shape args, traced contract/key)
# --------------------------------------------------------------------------


def _row_streams(
    contract_key: jax.Array,
    *,
    rows: int,
    row_offset: jax.Array | int,
    antithetic_half: int | None,
    dtype: jnp.dtype,
) -> tuple[jax.Array, jax.Array | None]:
    """Per-row stream keys + optional antithetic sign column.

    With ``antithetic_half=H``, global row r >= H reuses row (r−H)'s key with
    sign −1. The pairing is a pure function of the GLOBAL row index, so a
    mesh shard reproduces exactly its rows even when a pair's partner lives
    on another shard.
    """
    row_idx = jnp.asarray(row_offset, jnp.uint32) + jnp.arange(rows, dtype=jnp.uint32)
    if antithetic_half is None:
        base_idx, sign = row_idx, None
    else:
        h = jnp.uint32(antithetic_half)
        base_idx = jnp.where(row_idx < h, row_idx, row_idx - h)
        sign = jnp.where(row_idx < h, 1.0, -1.0).astype(dtype)[:, None]
    keys = jax.vmap(lambda r: jax.random.fold_in(contract_key, r))(base_idx)
    return keys, sign


def _step_coeffs(
    term: "TermStructure | None",
    *,
    timesteps: int,
    dtype: jnp.dtype,
    rate: jax.Array,
    div_yield: jax.Array,
    vol: jax.Array,
    dt: jax.Array,
    sqrt_dt: jax.Array,
) -> tuple[Callable[[jax.Array], jax.Array], Callable[[jax.Array], jax.Array], Callable[[jax.Array], jax.Array]]:
    """t-indexed ``(log_drift, lin_drift, vol_step)`` accessors.

    ``log_drift(t) = (r_t − q_t − v_t²/2)·dt`` (log-Euler increment mean),
    ``lin_drift(t) = (r_t − q_t)·dt`` (Euler drift),
    ``vol_step(t) = v_t·√dt``. Flat (``term is None``) returns scalars built
    with exactly the pre-term arithmetic, so the emitted values — hence the
    whole bit stream — are unchanged for existing configs.
    """
    if term is None:
        ld = (rate - div_yield - 0.5 * vol * vol) * dt
        lin = (rate - div_yield) * dt
        vstep = vol * sqrt_dt
        return (lambda t: ld), (lambda t: lin), (lambda t: vstep)
    vs, rs, qs = term.shapes(timesteps)
    vsa, rsa, qsa = (jnp.asarray(s, dtype) for s in (vs, rs, qs))
    vol_t = vol * vsa
    ld_arr = (rate * rsa - div_yield * qsa - 0.5 * vol_t * vol_t) * dt
    lin_arr = (rate * rsa - div_yield * qsa) * dt
    vstep_arr = vol_t * sqrt_dt
    return (lambda t: ld_arr[t]), (lambda t: lin_arr[t]), (lambda t: vstep_arr[t])


def _normals_source(
    contract_key: jax.Array,
    *,
    timesteps: int,
    rows: int,
    cols: int,
    dtype: jnp.dtype,
    row_offset: jax.Array | int,
    antithetic_half: int | None,
    sampling: "SamplingKind",
    mc_seed: int,
) -> "Callable[[jax.Array], jax.Array]":
    """``t -> [rows, cols]`` per-step normals closure — the sampling seam.

    PSEUDO: the canonical (contract_key, global row, timestep) threefry
    stream. SOBOL_BB: indexes a Brownian-bridge-ordered scrambled Sobol
    tensor materialized once per simulation (ops/qmc.py) — same shape, same
    marginals, same shard-stability in ``row_offset``.
    """
    if sampling == SamplingKind.SOBOL_BB:
        from spectralmc_tpu.ops.qmc import qmc_effective_normals

        assert antithetic_half is None  # enforced by build_simulation_params
        zq = qmc_effective_normals(
            contract_key,
            timesteps=timesteps,
            rows=rows,
            cols=cols,
            dtype=dtype,
            mc_seed=mc_seed,
            row_offset=row_offset,
        )

        def normals_qmc(t: jax.Array) -> jax.Array:
            return zq[t]

        return normals_qmc

    row_keys, sign = _row_streams(
        contract_key,
        rows=rows,
        row_offset=row_offset,
        antithetic_half=antithetic_half,
        dtype=dtype,
    )

    def normals(t: jax.Array) -> jax.Array:
        z = jax.vmap(
            lambda k: jax.random.normal(jax.random.fold_in(k, t), (cols,), dtype)
        )(row_keys)
        return z if sign is None else sign * z

    return normals


@partial(
    jax.jit,
    static_argnames=(
        "timesteps",
        "rows",
        "cols",
        "dtype",
        "scheme",
        "antithetic_half",
        "sampling",
        "mc_seed",
        "term",
    ),
)
def simulate_terminal_rows(
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
    sampling: SamplingKind = SamplingKind.PSEUDO,
    mc_seed: int = 0,
    term: "TermStructure | None" = None,
) -> jax.Array:
    """Terminal GBM values ``[rows, cols]`` for one contract.

    ``contract`` is the 6-vector [spot, strike, maturity, rate, div_yield, vol]
    (may be traced). The canonical RNG scheme addresses normals by
    ``(contract_key, global_row, timestep)``: row ``r``'s normals at step ``t``
    are ``normal(fold_in(fold_in(contract_key, row_offset + r), t), (cols,))``.
    Because rows are independently keyed, a mesh shard owning rows
    ``[k, k + rows)`` passes ``row_offset=k`` and reproduces *exactly* the bits
    a single-device run produces for those rows — the sharded spectrum matches
    the unsharded one to reduction-order tolerance (SURVEY §2.9 DP design).
    Resume is a pure function of (seed, draw counter) — no normals matrix
    exists anywhere (vs reference async_normals.py:105-466).
    """
    spot, _, maturity, rate, div_yield, vol = (contract[i].astype(dtype) for i in range(6))
    dt = maturity / jnp.asarray(timesteps, dtype)
    sqrt_dt = jnp.sqrt(dt)
    log_drift, lin_drift, vol_step = _step_coeffs(
        term,
        timesteps=timesteps,
        dtype=dtype,
        rate=rate,
        div_yield=div_yield,
        vol=vol,
        dt=dt,
        sqrt_dt=sqrt_dt,
    )

    if (
        sampling == SamplingKind.SOBOL_BB
        and scheme == PathScheme.LOG_EULER
        and term is None
    ):
        # Exact terminal shortcut: the bridge is orthogonal with
        # Σ_t increments = √T·z_0, and flat log-Euler drift is constant, so
        # log S_T = log S_0 + T·drift + vol·√dt·√T·z_0 — only Sobol
        # dimension 0 is live; the other T−1 dimensions, their ndtri, the
        # bridge matmul and the timestep scan are dead work (the cliquet
        # period kernel's one-draw-per-observable principle). Same terminal
        # variates as the full-path generator (qmc_terminal_normals
        # docstring); equal to the scan in exact arithmetic, differing only
        # in float summation order — SOBOL_BB is its own bit stream
        # (SamplingKind docstring) and carries no cross-version bit pin.
        from spectralmc_tpu.ops.qmc import qmc_terminal_normals

        z0 = qmc_terminal_normals(
            contract_key,
            timesteps=timesteps,
            rows=rows,
            cols=cols,
            dtype=dtype,
            mc_seed=mc_seed,
            row_offset=row_offset,
        )[0]
        t_steps = jnp.asarray(timesteps, dtype)
        log_t = (
            jnp.log(spot)
            + t_steps * log_drift(0)
            + vol_step(0) * jnp.sqrt(t_steps) * z0
        )
        return jnp.exp(log_t)

    normals = _normals_source(
        contract_key,
        timesteps=timesteps,
        rows=rows,
        cols=cols,
        dtype=dtype,
        row_offset=row_offset,
        antithetic_half=antithetic_half,
        sampling=sampling,
        mc_seed=mc_seed,
    )

    if scheme == PathScheme.LOG_EULER:

        def body(logx: jax.Array, t: jax.Array) -> tuple[jax.Array, None]:
            return logx + log_drift(t) + vol_step(t) * normals(t), None

        log0 = jnp.full((rows, cols), 0.0, dtype) + jnp.log(spot)
        log_t, _ = jax.lax.scan(body, log0, jnp.arange(timesteps))
        return jnp.exp(log_t)

    def body_euler(x: jax.Array, t: jax.Array) -> tuple[jax.Array, None]:
        x_next = x * (1.0 + lin_drift(t) + vol_step(t) * normals(t))
        return jnp.abs(x_next), None  # reflection, as the reference kernel

    x0 = jnp.full((rows, cols), 1.0, dtype) * spot
    x_t, _ = jax.lax.scan(body_euler, x0, jnp.arange(timesteps))
    return x_t


@partial(
    jax.jit,
    static_argnames=(
        "timesteps",
        "rows",
        "cols",
        "dtype",
        "scheme",
        "payoff",
        "barrier_rel",
        "antithetic_half",
        "lsmc_basis_degree",
        "lsmc_exercise_every",
        "forward_start_step",
        "cliquet_reset_every",
        "cliquet_floor",
        "cliquet_cap",
        "sampling",
        "mc_seed",
        "term",
    ),
)
def simulate_underlier_rows(
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
    lsmc_basis_degree: int = 5,
    lsmc_exercise_every: int = 1,
    forward_start_step: int | None = None,
    cliquet_reset_every: int | None = None,
    cliquet_floor: float | None = None,
    cliquet_cap: float | None = None,
    sampling: SamplingKind = SamplingKind.PSEUDO,
    mc_seed: int = 0,
    term: "TermStructure | None" = None,
) -> jax.Array:
    """``[rows, cols]`` payoff underliers: terminal value, path average,
    knockout-masked terminal (barrier kinds emit strike on knocked paths so
    both vanilla payoffs zero out), or the American kinds' synthetic
    ``strike − cashflow/df`` encoding (see ``PayoffKind``).

    Uses the exact bit stream of ``simulate_terminal_rows`` — normals keyed
    by (contract_key, global row, timestep) — so TERMINAL is identical to it
    and the path-dependent kinds are shard-stable the same way.
    """
    if payoff in AMERICAN_PAYOFFS:
        if sampling != SamplingKind.PSEUDO:
            # trace-time mirror of the build_simulation_params gate
            raise ValueError("LSMC early exercise draws its own pseudo stream")
        if scheme != PathScheme.LOG_EULER:
            # trace-time gate: the LSMC simulator hardcodes the log-Euler
            # step, and silently overriding a requested EULER discretization
            # would mislabel the estimator (build_simulation_params enforces
            # this for configs; direct callers get the same contract)
            raise ValueError("LSMC early exercise is log-Euler only")
        from spectralmc_tpu.ops.american import simulate_american_underlier_rows
        from spectralmc_tpu.ops.greeks import OptionSide

        return simulate_american_underlier_rows(
            contract_key,
            contract,
            timesteps=timesteps,
            rows=rows,
            cols=cols,
            dtype=dtype,
            option=OptionSide.PUT if payoff == PayoffKind.AMERICAN_PUT else OptionSide.CALL,
            basis_degree=lsmc_basis_degree,
            exercise_every=lsmc_exercise_every,
            row_offset=row_offset,
            antithetic_half=antithetic_half,
            term=term,
        )
    if payoff in (PayoffKind.TERMINAL, PayoffKind.DIGITAL):
        terminal = simulate_terminal_rows(
            contract_key,
            contract,
            timesteps=timesteps,
            rows=rows,
            cols=cols,
            dtype=dtype,
            scheme=scheme,
            row_offset=row_offset,
            antithetic_half=antithetic_half,
            sampling=sampling,
            mc_seed=mc_seed,
            term=term,
        )
        if payoff == PayoffKind.DIGITAL:
            strike = contract[1].astype(dtype)
            return strike + jnp.sign(terminal - strike)
        return terminal

    spot, _, maturity, rate, div_yield, vol = (contract[i].astype(dtype) for i in range(6))
    dt = maturity / jnp.asarray(timesteps, dtype)
    sqrt_dt = jnp.sqrt(dt)
    log_drift, lin_drift, vol_step = _step_coeffs(
        term,
        timesteps=timesteps,
        dtype=dtype,
        rate=rate,
        div_yield=div_yield,
        vol=vol,
        dt=dt,
        sqrt_dt=sqrt_dt,
    )
    normals = _normals_source(
        contract_key,
        timesteps=timesteps,
        rows=rows,
        cols=cols,
        dtype=dtype,
        row_offset=row_offset,
        antithetic_half=antithetic_half,
        sampling=sampling,
        mc_seed=mc_seed,
    )

    if payoff == PayoffKind.FORWARD_START:
        assert forward_start_step is not None  # enforced by build_simulation_params
        # state-free tail integration: S_T/S_m depends only on increments
        # m..N−1 under BOTH schemes (reflection included — x_T/x_m is the
        # product of the per-step |growth| factors), so the scan starts at m
        # and carries just the running log-ratio.
        if scheme == PathScheme.LOG_EULER:

            def body_f(acc: jax.Array, t: jax.Array) -> tuple[jax.Array, None]:
                return acc + log_drift(t) + vol_step(t) * normals(t), None

        else:

            def body_f(acc: jax.Array, t: jax.Array) -> tuple[jax.Array, None]:
                inc = jnp.log(jnp.abs(1.0 + lin_drift(t) + vol_step(t) * normals(t)))
                return acc + inc, None

        acc, _ = jax.lax.scan(
            body_f,
            jnp.zeros((rows, cols), dtype),
            jnp.arange(forward_start_step, timesteps),
        )
        return spot * jnp.exp(acc)

    if payoff == PayoffKind.CLIQUET:
        assert (  # enforced by build_simulation_params
            cliquet_reset_every is not None
            and cliquet_floor is not None
            and cliquet_cap is not None
        )
        # state-free like VARIANCE_SWAP: each period return is the product
        # of per-step growth factors, so the scan carries the running period
        # log-return and the clipped accumulator; at reset boundaries
        # ((t+1) % k == 0) the period closes into the accumulator.
        floor_c = jnp.asarray(cliquet_floor, dtype)
        cap_c = jnp.asarray(cliquet_cap, dtype)
        k_c = cliquet_reset_every

        def close_period(
            per: jax.Array, acc: jax.Array, t: jax.Array
        ) -> tuple[jax.Array, jax.Array]:
            boundary = (t + 1) % k_c == 0
            clipped = jnp.clip(jnp.exp(per) - 1.0, floor_c, cap_c)
            acc = jnp.where(boundary, acc + clipped, acc)
            per = jnp.where(boundary, 0.0, per)
            return per, acc

        if scheme == PathScheme.LOG_EULER:

            def body_c(
                carry: tuple[jax.Array, jax.Array], t: jax.Array
            ) -> tuple[tuple[jax.Array, jax.Array], None]:
                per, acc = carry
                per = per + log_drift(t) + vol_step(t) * normals(t)
                return close_period(per, acc, t), None

        else:

            def body_c(
                carry: tuple[jax.Array, jax.Array], t: jax.Array
            ) -> tuple[tuple[jax.Array, jax.Array], None]:
                per, acc = carry
                per = per + jnp.log(jnp.abs(1.0 + lin_drift(t) + vol_step(t) * normals(t)))
                return close_period(per, acc, t), None

        zeros_c = jnp.zeros((rows, cols), dtype)
        (_, acc), _ = jax.lax.scan(body_c, (zeros_c, zeros_c), jnp.arange(timesteps))
        return acc

    if payoff == PayoffKind.VARIANCE_SWAP:
        # RV needs only the log-increments — no path state at all under
        # either scheme (log-Euler: inc = drift + vol·z; Euler: the ratio
        # x'/x = |1 + lin + vol·z| is state-free), so the scan carries just
        # the running sum of squares.
        if scheme == PathScheme.LOG_EULER:

            def body_v(acc: jax.Array, t: jax.Array) -> tuple[jax.Array, None]:
                inc = log_drift(t) + vol_step(t) * normals(t)
                return acc + inc * inc, None

        else:

            def body_v(acc: jax.Array, t: jax.Array) -> tuple[jax.Array, None]:
                inc = jnp.log(jnp.abs(1.0 + lin_drift(t) + vol_step(t) * normals(t)))
                return acc + inc * inc, None

        acc, _ = jax.lax.scan(body_v, jnp.zeros((rows, cols), dtype), jnp.arange(timesteps))
        return acc / maturity

    if payoff in BARRIER_PAYOFFS:
        assert barrier_rel is not None  # enforced by build_simulation_params
        strike = contract[1].astype(dtype)
        up = payoff == PayoffKind.BARRIER_UP_OUT
        extreme_fn = jnp.maximum if up else jnp.minimum
        if scheme == PathScheme.LOG_EULER:
            level = jnp.log(spot * jnp.asarray(barrier_rel, dtype))

            def body_b(
                carry: tuple[jax.Array, jax.Array], t: jax.Array
            ) -> tuple[tuple[jax.Array, jax.Array], None]:
                logx, ext = carry
                logx = logx + log_drift(t) + vol_step(t) * normals(t)
                return (logx, extreme_fn(ext, logx)), None

            log0 = jnp.full((rows, cols), 0.0, dtype) + jnp.log(spot)
            (logx, ext), _ = jax.lax.scan(body_b, (log0, log0), jnp.arange(timesteps))
            terminal = jnp.exp(logx)
        else:
            level = spot * jnp.asarray(barrier_rel, dtype)

            def body_be(
                carry: tuple[jax.Array, jax.Array], t: jax.Array
            ) -> tuple[tuple[jax.Array, jax.Array], None]:
                x, ext = carry
                x = jnp.abs(x * (1.0 + lin_drift(t) + vol_step(t) * normals(t)))
                return (x, extreme_fn(ext, x)), None

            x0 = jnp.full((rows, cols), 1.0, dtype) * spot
            (terminal, ext), _ = jax.lax.scan(body_be, (x0, x0), jnp.arange(timesteps))
        knocked = ext >= level if up else ext <= level
        return jnp.where(knocked, strike, terminal)

    if payoff in LOOKBACK_PAYOFFS:
        strike = contract[1].astype(dtype)
        extreme_fn = jnp.maximum if payoff in LOOKBACK_MAX_PAYOFFS else jnp.minimum
        if scheme == PathScheme.LOG_EULER:

            def body_l(
                carry: tuple[jax.Array, jax.Array], t: jax.Array
            ) -> tuple[tuple[jax.Array, jax.Array], None]:
                logx, ext = carry
                logx = logx + log_drift(t) + vol_step(t) * normals(t)
                return (logx, extreme_fn(ext, logx)), None

            log0 = jnp.full((rows, cols), 0.0, dtype) + jnp.log(spot)
            (logx, ext), _ = jax.lax.scan(body_l, (log0, log0), jnp.arange(timesteps))
            terminal, extreme = jnp.exp(logx), jnp.exp(ext)
        else:

            def body_le(
                carry: tuple[jax.Array, jax.Array], t: jax.Array
            ) -> tuple[tuple[jax.Array, jax.Array], None]:
                x, ext = carry
                x = jnp.abs(x * (1.0 + lin_drift(t) + vol_step(t) * normals(t)))
                return (x, extreme_fn(ext, x)), None

            x0 = jnp.full((rows, cols), 1.0, dtype) * spot
            (terminal, extreme), _ = jax.lax.scan(body_le, (x0, x0), jnp.arange(timesteps))
        return lookback_underlier(payoff, strike, extreme, terminal)

    geometric = payoff == PayoffKind.ASIAN_GEOMETRIC
    if scheme == PathScheme.LOG_EULER:

        def body(
            carry: tuple[jax.Array, jax.Array], t: jax.Array
        ) -> tuple[tuple[jax.Array, jax.Array], None]:
            logx, acc = carry
            logx = logx + log_drift(t) + vol_step(t) * normals(t)
            acc = acc + (logx if geometric else jnp.exp(logx))
            return (logx, acc), None

        log0 = jnp.full((rows, cols), 0.0, dtype) + jnp.log(spot)
        (_, acc), _ = jax.lax.scan(
            body, (log0, jnp.zeros((rows, cols), dtype)), jnp.arange(timesteps)
        )
    else:

        def body_euler(
            carry: tuple[jax.Array, jax.Array], t: jax.Array
        ) -> tuple[tuple[jax.Array, jax.Array], None]:
            x, acc = carry
            x = jnp.abs(x * (1.0 + lin_drift(t) + vol_step(t) * normals(t)))
            acc = acc + (jnp.log(x) if geometric else x)
            return (x, acc), None

        x0 = jnp.full((rows, cols), 1.0, dtype) * spot
        (_, acc), _ = jax.lax.scan(
            body_euler, (x0, jnp.zeros((rows, cols), dtype)), jnp.arange(timesteps)
        )
    mean = acc / jnp.asarray(timesteps, dtype)
    return jnp.exp(mean) if geometric else mean


def expected_clipped_lognormal_return(
    mu: jax.Array, s: jax.Array, floor: jax.Array, cap: jax.Array
) -> jax.Array:
    """E[clip(e^X − 1, floor, cap)] for X ~ N(mu, s²) — closed form.

    floor·Φ(z_f) + e^{μ+s²/2}(Φ(z_c−s) − Φ(z_f−s)) − (Φ(z_c) − Φ(z_f))
    + cap·(1 − Φ(z_c)) with z = (ln(1+level) − μ)/s. Broadcasts over its
    arguments (per-period μ/s vectors under term curves); the cliquet
    parity target is the sum over periods.
    """
    from jax.scipy.special import erf

    def phi(z: jax.Array) -> jax.Array:
        return 0.5 * (1.0 + erf(z / jnp.sqrt(jnp.asarray(2.0, z.dtype))))

    zf = (jnp.log1p(floor) - mu) / s
    zc = (jnp.log1p(cap) - mu) / s
    body = jnp.exp(mu + 0.5 * s * s) * (phi(zc - s) - phi(zf - s)) - (phi(zc) - phi(zf))
    return floor * phi(zf) + body + cap * (1.0 - phi(zc))


def expected_underlier_mean(
    contract: jax.Array,
    *,
    timesteps: int,
    payoff: PayoffKind,
    dtype: jnp.dtype,
    term: "TermStructure | None" = None,
    forward_start_step: int | None = None,
    cliquet_reset_every: int | None = None,
    cliquet_floor: float | None = None,
    cliquet_cap: float | None = None,
) -> jax.Array | None:
    """Analytic E[underlier] under the log-Euler discretization.

    The forward-normalization target (reference gbm.py:433-440 uses the
    terminal forward; the Asian kinds need the mean of their own average).
    Exact for LOG_EULER; for EULER it is the continuous-limit approximation.
    None for barrier kinds (the knocked-out mean has no closed form) and the
    American kinds (the synthetic underlier's mean IS the unknown price).
    With a ``term`` structure the means follow the per-step curves exactly
    (cumulative drift sums replace the flat geometric series).
    """
    if payoff in BARRIER_PAYOFFS or payoff in AMERICAN_PAYOFFS:
        return None
    if payoff in LOOKBACK_PAYOFFS:
        return None  # E[running extreme] has no closed form on a discrete grid
    if payoff == PayoffKind.DIGITAL:
        # E[u] = K + P(S_T>K) − P(S_T<K) = K + 2·N(d2_eff) − 1, exact for
        # the log-Euler terminal law (flat or curved). Feeds call-via-parity
        # (call − put = (E[u] − K)·df reproduces the digital parity
        # call + put = df); MEAN normalization is gated off separately.
        from jax.scipy.special import erf

        spot_d, strike_d, maturity_d, rate_d, div_d, vol_d = (
            contract[i].astype(dtype) for i in range(6)
        )
        if term is not None and not term.is_flat():
            vs, rs, qs = term.shapes(timesteps)
            n_t = jnp.asarray(timesteps, dtype)
            dt_t = maturity_d / n_t
            vsa, rsa, qsa = (jnp.asarray(s, dtype) for s in (vs, rs, qs))
            var = jnp.sum((vol_d * vsa) ** 2 * dt_t)
            drift = jnp.sum((rate_d * rsa - div_d * qsa) * dt_t)
        else:
            var = vol_d * vol_d * maturity_d
            drift = (rate_d - div_d) * maturity_d
        d2 = (jnp.log(spot_d / strike_d) + drift - 0.5 * var) / jnp.sqrt(var)
        n_d2 = 0.5 * (1.0 + erf(d2 / jnp.sqrt(jnp.asarray(2.0, dtype))))
        return strike_d + 2.0 * n_d2 - 1.0
    if payoff == PayoffKind.VARIANCE_SWAP:
        # E[RV] = (1/T)·Σ_t (a_t² + v_t²·dt) with a_t the per-step log-drift
        # — exact under log-Euler (each increment is Gaussian(a_t, v_t²dt));
        # for EULER it is the continuous-limit approximation, like the
        # Asian formulas above.
        _, _, maturity_v, rate_v, div_v, vol_v = (
            contract[i].astype(dtype) for i in range(6)
        )
        n_v = jnp.asarray(timesteps, dtype)
        dt_v = maturity_v / n_v
        if term is not None and not term.is_flat():
            vs, rs, qs = term.shapes(timesteps)
            vsa, rsa, qsa = (jnp.asarray(s, dtype) for s in (vs, rs, qs))
            vol_t = vol_v * vsa
            a_t = (rate_v * rsa - div_v * qsa - 0.5 * vol_t * vol_t) * dt_v
            return jnp.sum(a_t * a_t + vol_t * vol_t * dt_v) / maturity_v
        a_f = (rate_v - div_v - 0.5 * vol_v * vol_v) * dt_v
        return n_v * (a_f * a_f + vol_v * vol_v * dt_v) / maturity_v
    if payoff == PayoffKind.FORWARD_START:
        # E[u] = spot·E[S_T/S_m] = spot·exp(Σ_{t≥m}(r_t − q_t)dt) — exact
        # under log-Euler (each tail growth factor has mean e^{(r_t−q_t)dt});
        # continuous-limit approximation for EULER like the kinds above.
        assert forward_start_step is not None
        spot_f, _, maturity_f, rate_f, div_f, _ = (
            contract[i].astype(dtype) for i in range(6)
        )
        dt_f = maturity_f / jnp.asarray(timesteps, dtype)
        if term is not None and not term.is_flat():
            vs, rs, qs = term.shapes(timesteps)
            rsa, qsa = (jnp.asarray(s, dtype) for s in (rs, qs))
            tail = jnp.arange(timesteps) >= forward_start_step
            lin_t = (rate_f * rsa - div_f * qsa) * dt_f
            return spot_f * jnp.exp(jnp.sum(jnp.where(tail, lin_t, 0.0)))
        n_tail = jnp.asarray(timesteps - forward_start_step, dtype)
        return spot_f * jnp.exp((rate_f - div_f) * dt_f * n_tail)
    if payoff == PayoffKind.CLIQUET:
        # E[u] = Σ_j E[clip(R_j)] — each period's log-return is Gaussian
        # with μ_j = Σ_{t∈period j} a_t, s_j² = Σ_{t∈period j} v_t²·dt
        # (exact under log-Euler, flat or curved; continuous-limit
        # approximation for EULER like the kinds above).
        assert (
            cliquet_reset_every is not None
            and cliquet_floor is not None
            and cliquet_cap is not None
        )
        _, _, maturity_c, rate_c, div_c, vol_c = (
            contract[i].astype(dtype) for i in range(6)
        )
        k_c = cliquet_reset_every
        periods = timesteps // k_c
        dt_c = maturity_c / jnp.asarray(timesteps, dtype)
        floor_a = jnp.asarray(cliquet_floor, dtype)
        cap_a = jnp.asarray(cliquet_cap, dtype)
        if term is not None and not term.is_flat():
            vs, rs, qs = term.shapes(timesteps)
            vsa, rsa, qsa = (jnp.asarray(s, dtype) for s in (vs, rs, qs))
            vol_t = vol_c * vsa
            a_t = (rate_c * rsa - div_c * qsa - 0.5 * vol_t * vol_t) * dt_c
            mu_j = jnp.sum(a_t.reshape(periods, k_c), axis=1)
            s_j = jnp.sqrt(jnp.sum((vol_t * vol_t * dt_c).reshape(periods, k_c), axis=1))
            return jnp.sum(
                expected_clipped_lognormal_return(mu_j, s_j, floor_a, cap_a)
            )
        mu_p = (rate_c - div_c - 0.5 * vol_c * vol_c) * dt_c * k_c
        s_p = vol_c * jnp.sqrt(dt_c * jnp.asarray(k_c, dtype))
        return jnp.asarray(periods, dtype) * expected_clipped_lognormal_return(
            mu_p, s_p, floor_a, cap_a
        )
    if term is not None and term.is_flat():
        # all-ones curves must reproduce the flat formulas bit-for-bit (the
        # weighted sums below are the same values in exact arithmetic but a
        # different fp summation order)
        term = None
    spot, _, maturity, rate, div_yield, vol = (contract[i].astype(dtype) for i in range(6))
    n = jnp.asarray(timesteps, dtype)
    dt = maturity / n
    if term is not None:
        vs, rs, qs = term.shapes(timesteps)
        vsa, rsa, qsa = (jnp.asarray(s, dtype) for s in (vs, rs, qs))
        lin = (rate * rsa - div_yield * qsa) * dt  # [T] per-step (r_t - q_t) dt
        cum_lin = jnp.cumsum(lin)  # drift integral up to t_{k}
        if payoff == PayoffKind.TERMINAL:
            return spot * jnp.exp(cum_lin[-1])
        if payoff == PayoffKind.ASIAN_ARITHMETIC:
            # (1/N) sum_k E[S_{t_k}] = (1/N) sum_k S0 exp(sum_{j<k}(r_j-q_j)dt)
            return spot * jnp.mean(jnp.exp(cum_lin))
        # ASIAN_GEOMETRIC: mean of log S over the grid is Gaussian with
        # mu = ln S0 + sum_j a_j (N-j)/N, s2 = sum_j b_j^2 ((N-j)/N)^2
        vol_t = vol * vsa
        a = lin - 0.5 * vol_t * vol_t * dt
        w = (n - jnp.arange(timesteps, dtype=dtype)) / n
        mu = jnp.log(spot) + jnp.sum(a * w)
        s2 = jnp.sum(vol_t * vol_t * dt * w * w)
        return jnp.exp(mu + 0.5 * s2)
    if payoff == PayoffKind.TERMINAL:
        return spot * jnp.exp((rate - div_yield) * maturity)
    if payoff == PayoffKind.ASIAN_ARITHMETIC:
        # (1/N) sum_{i=1..N} S0 e^{(r-q) i dt} — a finite geometric series
        g = jnp.exp((rate - div_yield) * dt)
        # guard g == 1 (r == q): the series degenerates to N terms of S0
        series = jnp.where(
            jnp.abs(g - 1.0) < 1e-12, n, g * (g**n - 1.0) / (g - 1.0)
        )
        return spot * series / n
    # ASIAN_GEOMETRIC: ln G ~ N(mu, s^2) exactly under log-Euler
    mu = jnp.log(spot) + (rate - div_yield - 0.5 * vol * vol) * dt * (n + 1.0) / 2.0
    s2 = vol * vol * dt * (n + 1.0) * (2.0 * n + 1.0) / (6.0 * n)
    return jnp.exp(mu + 0.5 * s2)


def simulate_terminal(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    batches: int,
    network_size: int,
    dtype: jnp.dtype,
    scheme: PathScheme,
) -> jax.Array:
    """Flat terminal values ``[batches * network_size]`` (single-device view)."""
    return simulate_terminal_rows(
        contract_key,
        contract,
        timesteps=timesteps,
        rows=batches,
        cols=network_size,
        dtype=dtype,
        scheme=scheme,
    ).reshape(batches * network_size)


@partial(
    jax.jit, static_argnames=("timesteps", "paths", "dtype", "scheme", "normalize", "term")
)
def simulate_paths(
    contract_key: jax.Array,
    contract: jax.Array,
    *,
    timesteps: int,
    paths: int,
    dtype: jnp.dtype,
    scheme: PathScheme,
    normalize: bool,
    term: "TermStructure | None" = None,
) -> jax.Array:
    """Full ``[timesteps, paths]`` path matrix (parity/test path).

    Row ``t`` is the state after step ``t+1``, matching the reference kernel's
    in-place layout (gbm.py:241-257). With ``normalize`` each row is rescaled
    so its mean equals the analytic forward at that time (gbm.py:433-440).
    """
    spot, _, maturity, rate, div_yield, vol = (contract[i].astype(dtype) for i in range(6))
    dt = maturity / jnp.asarray(timesteps, dtype)
    sqrt_dt = jnp.sqrt(dt)
    log_drift, lin_drift, vol_step = _step_coeffs(
        term,
        timesteps=timesteps,
        dtype=dtype,
        rate=rate,
        div_yield=div_yield,
        vol=vol,
        dt=dt,
        sqrt_dt=sqrt_dt,
    )

    def body(x: jax.Array, t: jax.Array) -> tuple[jax.Array, jax.Array]:
        z = jax.random.normal(jax.random.fold_in(contract_key, t), (paths,), dtype)
        if scheme == PathScheme.LOG_EULER:
            x_next = x * jnp.exp(log_drift(t) + vol_step(t) * z)
        else:
            x_next = jnp.abs(x * (1.0 + lin_drift(t) + vol_step(t) * z))
        return x_next, x_next

    x0 = jnp.full((paths,), 1.0, dtype) * spot
    _, rows = jax.lax.scan(body, x0, jnp.arange(timesteps))
    if normalize:
        if term is None:
            times = (jnp.arange(1, timesteps + 1, dtype=dtype)) * dt
            forwards = spot * jnp.exp((rate - div_yield) * times)
        else:
            _, rs, qs = term.shapes(timesteps)
            rsa, qsa = jnp.asarray(rs, dtype), jnp.asarray(qs, dtype)
            forwards = spot * jnp.exp(jnp.cumsum((rate * rsa - div_yield * qsa) * dt))
        rows = rows * (forwards / jnp.mean(rows, axis=1))[:, None]
    return rows


@dataclass(frozen=True)
class SimPrices:
    """Discounted payoff vectors + scalars (parity: reference gbm.py:450-521)."""

    put_payoffs: jax.Array  # [total_paths] discounted
    call_payoffs: jax.Array  # [total_paths] discounted
    forward: jax.Array
    discount_factor: jax.Array


def terminal_to_prices(
    terminal: jax.Array,
    contract: jax.Array,
    *,
    normalize: bool,
    dtype: jnp.dtype,
    mean_target: jax.Array | None = None,
    term: "TermStructure | None" = None,
) -> SimPrices:
    """Payoff vectors from underlier values, with optional mean normalization.

    ``mean_target`` is the analytic E[underlier] the sample mean is rescaled
    to; defaults to the terminal forward (the reference's normalization,
    gbm.py:433-440 — correct for TERMINAL payoffs only). With a ``term``
    structure, discounting and the forward use the curve-effective rates
    (``exp(-∫r)``, ``exp(∫(r−q))``) instead of the flat contract scalars.
    """
    spot, strike, maturity, rate, div_yield, _ = (contract[i].astype(dtype) for i in range(6))
    if term is None or term.n_steps() is None:
        forward = spot * jnp.exp((rate - div_yield) * maturity)
        df = jnp.exp(-rate * maturity)
    else:
        _, mr, mq = term.effective_factors(term.n_steps() or 1)
        forward = spot * jnp.exp((rate * mr - div_yield * mq) * maturity)
        df = jnp.exp(-rate * mr * maturity)
    if normalize:
        target = forward if mean_target is None else mean_target
        terminal = terminal * (target / jnp.mean(terminal))
    put = df * jnp.maximum(strike - terminal, 0.0)
    call = df * jnp.maximum(terminal - strike, 0.0)
    return SimPrices(put_payoffs=put, call_payoffs=call, forward=forward, discount_factor=df)


@dataclass(frozen=True)
class HostPrices:
    """Host scalars incl. intrinsics/convexities (parity: gbm.py:491-521)."""

    put: float
    call: float
    put_intrinsic: float
    call_intrinsic: float
    put_convexity: float
    call_convexity: float
    forward: float
    discount_factor: float


# --------------------------------------------------------------------------
# Engine facade
# --------------------------------------------------------------------------


class BlackScholes:
    """Stateless pricing engine over ``SimulationParams``.

    Unlike the reference engine (which owns CUDA streams and a generator
    pool, gbm.py:308-329) this object holds only the frozen params; all
    compute is pure jitted functions. ``price`` consumes one draw counter per
    call and returns the advanced engine alongside the prices, keeping resume
    state explicit.
    """

    def __init__(self, params: SimulationParams) -> None:
        if params.model != ModelKind.GBM:
            raise ValueError(
                f"BlackScholes simulates GBM only; params.model={params.model.value!r}. "
                "Heston/basket pricing goes through ops/heston.py / ops/basket.py "
                "simulators or the trainer (ops/dispatch.py selects on ModelKind)."
            )
        self._params = params
        self._key = jax.random.PRNGKey(params.mc_seed)

    @property
    def params(self) -> SimulationParams:
        return self._params

    def snapshot(self) -> SimulationParams:
        """Checkpointable state — params already carry the skip (gbm.py:332-339)."""
        return self._params

    def contract_key(self, draw_index: int | jax.Array) -> jax.Array:
        return jax.random.fold_in(self._key, draw_index)

    def simulate_terminal(self, contract: jax.Array, draw_index: int | jax.Array) -> jax.Array:
        p = self._params
        kwargs: dict[str, object] = {}
        # resolve_implementation routes AMERICAN to XLA (no Pallas LSMC)
        if resolve_implementation(p) == SimImplementation.PALLAS:
            from spectralmc_tpu.ops.gbm_pallas import simulate_underlier_rows_pallas

            simulate = simulate_underlier_rows_pallas
            if p.term is not None:
                kwargs["term"] = p.term
            if p.cliquet_reset_every is not None:
                # GBM flat log-Euler cliquets run the per-period kernel
                kwargs["cliquet_reset_every"] = p.cliquet_reset_every
                kwargs["cliquet_floor"] = p.cliquet_floor
                kwargs["cliquet_cap"] = p.cliquet_cap
        else:
            simulate = simulate_underlier_rows
            if p.payoff in AMERICAN_PAYOFFS:
                kwargs["lsmc_basis_degree"] = p.lsmc_basis_degree
                kwargs["lsmc_exercise_every"] = p.lsmc_exercise_every
            if p.sampling != SamplingKind.PSEUDO:
                kwargs["sampling"] = p.sampling
                kwargs["mc_seed"] = p.mc_seed
            if p.term is not None:
                kwargs["term"] = p.term
            if p.cliquet_reset_every is not None:
                kwargs["cliquet_reset_every"] = p.cliquet_reset_every
                kwargs["cliquet_floor"] = p.cliquet_floor
                kwargs["cliquet_cap"] = p.cliquet_cap
        if p.forward_start_step is not None:
            kwargs["forward_start_step"] = p.forward_start_step
        return simulate(
            self.contract_key(draw_index),
            contract,
            timesteps=p.timesteps,
            rows=p.batches_per_mc_run,
            cols=p.network_size,
            dtype=p.precision.to_jnp(),
            scheme=p.scheme,
            payoff=p.payoff,
            barrier_rel=p.barrier_rel,
            antithetic_half=p.batches_per_mc_run // 2 if p.antithetic else None,
            **kwargs,
        ).reshape(p.batches_per_mc_run * p.network_size)

    def price(self, contract: BlackScholesContract) -> tuple[SimPrices, "BlackScholes"]:
        p = self._params
        dtype = p.precision.to_jnp()
        arr = contract.as_array(dtype)
        terminal = self.simulate_terminal(arr, p.skip)
        prices = terminal_to_prices(
            terminal,
            arr,
            normalize=p.normalization == ForwardNormalization.MEAN,
            dtype=dtype,
            mean_target=expected_underlier_mean(
                arr,
                timesteps=p.timesteps,
                payoff=p.payoff,
                dtype=dtype,
                term=p.term,
                forward_start_step=p.forward_start_step,
                cliquet_reset_every=p.cliquet_reset_every,
                cliquet_floor=p.cliquet_floor,
                cliquet_cap=p.cliquet_cap,
            ),
            term=p.term,
        )
        advanced = BlackScholes(p.model_copy(update={"skip": p.skip + 1}))
        return prices, advanced

    def price_to_host(self, contract: BlackScholesContract) -> tuple[HostPrices, "BlackScholes"]:
        prices, advanced = self.price(contract)
        put = float(jnp.mean(prices.put_payoffs))
        call = float(jnp.mean(prices.call_payoffs))
        fwd = float(prices.forward)
        df = float(prices.discount_factor)
        put_intr = df * max(contract.strike - fwd, 0.0)
        call_intr = df * max(fwd - contract.strike, 0.0)
        return (
            HostPrices(
                put=put,
                call=call,
                put_intrinsic=put_intr,
                call_intrinsic=call_intr,
                put_convexity=put - put_intr,
                call_convexity=call - call_intr,
                forward=fwd,
                discount_factor=df,
            ),
            advanced,
        )
