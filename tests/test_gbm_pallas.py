"""Pallas kernel tests (Triton route, interpret mode on the CPU).

Here we verify: the in-kernel threefry stream against ``jax.random``'s own
threefry and a plain-jnp replay of the kernel's draws (block shape and
``row_offset`` independence included), structure under the zero-bit
stream (``tests.helpers.kernels.zero_bits``: every path is the same deterministic
path, a sharp analytic check of everything except the RNG distribution),
and the wrappers' refusals where a kernel cannot run. Statistical checks of
the compiled kernels against closed forms run on the card (``chip_smoke.py``
and the ``card``-marked tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from tests.helpers.kernels import zero_bits

from spectralmc_tpu.ops.gbm import PathScheme
from spectralmc_tpu.ops.gbm_pallas import (
    simulate_terminal_pallas,
    simulate_terminal_rows_pallas,
)
from tests.helpers.factories import make_contract

CONTRACT = make_contract(vol=0.25)


def _run_interpret(scheme: PathScheme, timesteps: int = 8, rows: int = 8, cols: int = 128):
    key = jax.random.PRNGKey(1)
    arr = CONTRACT.as_array(jnp.float32)
    with zero_bits():
        return simulate_terminal_rows_pallas(
            key, arr, timesteps=timesteps, rows=rows, cols=cols,
            dtype=jnp.float32, scheme=scheme, interpret=True,
        )


def test_interpret_mode_zero_normals_log_euler_is_pure_drift() -> None:
    """With the zero-bit stream, u1 = half-ulp exactly, so
    z = sqrt(-2 ln u1) deterministically; every path follows the same drift.
    We verify shape, finiteness, and that all paths are identical — the
    deterministic skeleton of the kernel is correct."""
    rows = _run_interpret(PathScheme.LOG_EULER)
    assert rows.shape == (8, 128)
    t = np.asarray(rows)
    assert np.all(np.isfinite(t))
    assert np.all(t > 0)
    assert np.allclose(t, t[0, 0])  # zero-bit RNG -> identical paths
    # exact value under the pair-step scheme: zero bits give u1 = 2^-25,
    # u2 = 0, so each of the 4 pairs adds 2*drift + vol*sqrt(dt)*r with
    # r = sqrt(-2 ln 2^-25) (cos(0)=1, sin(0)=0).
    c = CONTRACT
    r = np.sqrt(-2.0 * np.log(np.float32(2.0**-25)))
    dt = c.maturity / 8
    drift = (c.rate - c.div_yield - 0.5 * c.vol**2) * dt
    expected = c.spot * np.exp(8 * drift + 4 * c.vol * np.sqrt(dt) * r)
    np.testing.assert_allclose(t[0, 0], expected, rtol=1e-4)


def test_interpret_mode_euler_reflection_positive() -> None:
    rows = _run_interpret(PathScheme.EULER)
    assert np.all(np.asarray(rows) > 0)  # reflection keeps paths positive


def test_flat_api_shape() -> None:
    key = jax.random.PRNGKey(1)
    arr = CONTRACT.as_array(jnp.float32)
    with zero_bits():
        flat = simulate_terminal_pallas(
            key, arr, timesteps=2, batches=8, network_size=128,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER, interpret=True,
        )
    assert flat.shape == (8 * 128,)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(dtype=jnp.float64, rows=8, cols=128, interpret=True),  # fp64
        dict(dtype=jnp.float32, rows=7, cols=100, interpret=True),  # not pow2
        dict(dtype=jnp.float32, rows=12, cols=128, interpret=True),  # ragged
        dict(dtype=jnp.float32, rows=8, cols=128, interpret=False),  # no GPU
    ],
)
def test_fallback_to_xla(kwargs) -> None:
    """No silent fallback: an unsupported dtype, shape or backend raises
    (gbm.resolve_implementation is the one router to the XLA engine)."""
    key = jax.random.PRNGKey(5)
    arr = CONTRACT.as_array(kwargs["dtype"])
    with pytest.raises(ValueError, match="resolve_implementation"):
        simulate_terminal_rows_pallas(
            key, arr, timesteps=2, rows=kwargs["rows"], cols=kwargs["cols"],
            dtype=kwargs["dtype"], scheme=PathScheme.LOG_EULER,
            interpret=kwargs["interpret"],
        )


def test_row_offset_falls_back_and_passes_through() -> None:
    """A shard owning rows [8, 16) passes row_offset=8 and reproduces exactly
    the global rows of the unsharded kernel (the sharding contract, SURVEY
    §2.9 DP design) — the stream is keyed by the GLOBAL row."""
    key = jax.random.PRNGKey(3)
    arr = CONTRACT.as_array(jnp.float32)
    kw = dict(timesteps=4, cols=128, dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
              interpret=True)
    full = np.asarray(simulate_terminal_rows_pallas(key, arr, rows=16, **kw))
    hi = np.asarray(simulate_terminal_rows_pallas(key, arr, rows=8, row_offset=8, **kw))
    assert np.array_equal(hi, full[8:])


def test_threefry_matches_jax_random() -> None:
    """The in-kernel block function IS jax.random's threefry-2x32."""
    from jax.extend.random import threefry_2x32

    from spectralmc_tpu.ops.gbm_pallas import threefry2x32

    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(3, 64), dtype=np.uint64).astype(np.uint32)
    for k0, k1 in ((0, 0), (123, 456), (0xFFFFFFFF, 0x9E3779B9)):
        key = jnp.array([k0, k1], jnp.uint32)
        x0, x1 = jnp.asarray(words[0]), jnp.asarray(words[1])
        want = np.asarray(threefry_2x32(key, jnp.concatenate([x0, x1])))
        y0, y1 = threefry2x32(key[0], key[1], x0, x1)
        np.testing.assert_array_equal(np.concatenate([y0, y1]), want)


def _replay_terminal(key, arr, *, timesteps, rows, cols, antithetic=False):
    """Plain-jnp replay of the flat log-Euler TERMINAL kernel from
    ``stream_bits``: pair draw p advances two steps with
    r·√2·sin(2π(u2 + 1/8))."""
    from spectralmc_tpu.ops.gbm_pallas import _bm_radius, _sin_turns, _unit, stream_bits

    words = jax.random.key_data(key).astype(jnp.uint32).reshape(2)
    r_idx = jnp.arange(rows, dtype=jnp.uint32)[:, None]
    c_idx = jnp.arange(cols, dtype=jnp.uint32)[None, :]
    spot, _, mat, rate, div, vol = (float(x) for x in arr)
    dt = mat / timesteps
    drift = (rate - div - 0.5 * vol * vol) * dt
    logx = jnp.full((rows, cols), np.log(spot), jnp.float32)
    sign = 1.0 - 2.0 * (r_idx % 2).astype(jnp.float32) if antithetic else 1.0
    for p in range(timesteps // 2):
        b0, b1 = stream_bits(
            (words[0], words[1]), r_idx, c_idx, p, total_cols=cols, antithetic=antithetic
        )
        u1 = _unit(b0) + jnp.float32(2.0**-25)
        z = _bm_radius(u1) * jnp.float32(np.sqrt(2.0)) * _sin_turns(_unit(b1) + jnp.float32(0.125))
        logx = logx + jnp.float32(2.0 * drift) + jnp.float32(vol * np.sqrt(dt)) * (sign * z)
    return np.exp(np.asarray(logx))


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("block", [(8, 128), (2, 32), (16, 256)])
def test_kernel_stream_matches_plain_replay_any_block(
    monkeypatch: pytest.MonkeyPatch, block: tuple[int, int], antithetic: bool
) -> None:
    """The kernel's draws are the plain-jnp ``stream_bits`` replay, whatever
    the block shape: the stream is addressed by (key, global row, global
    column, draw), not by the program that evaluates it."""
    from spectralmc_tpu.ops import gbm_pallas as gp

    monkeypatch.setattr(gp, "BLOCK_ROWS", block[0])
    monkeypatch.setattr(gp, "BLOCK_COLS", block[1])
    jax.clear_caches()
    key = jax.random.PRNGKey(7)
    arr = CONTRACT.as_array(jnp.float32)
    got = np.asarray(
        simulate_terminal_rows_pallas(
            key, arr, timesteps=4, rows=16, cols=256, dtype=jnp.float32,
            scheme=PathScheme.LOG_EULER, interpret=True,
            antithetic_half=8 if antithetic else None,
        )
    )
    jax.clear_caches()
    want = _replay_terminal(key, arr, timesteps=4, rows=16, cols=256, antithetic=antithetic)
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_terminal_pathwise_vjp_matches_autodiff() -> None:
    """The analytic pathwise rule (the Pallas kernel's backward pass) must
    equal jax.grad of the XLA log-Euler simulator — same math, so the rule
    is verified off-TPU by differentiating the transparent engine."""
    from spectralmc_tpu.ops.gbm import simulate_terminal_rows
    from spectralmc_tpu.ops.gbm_pallas import terminal_pathwise_vjp

    key = jax.random.PRNGKey(9)
    arr = CONTRACT.as_array(jnp.float64)
    kw = dict(timesteps=6, rows=16, cols=64, dtype=jnp.float64,
              scheme=PathScheme.LOG_EULER)
    # an arbitrary smooth reduction with non-uniform cotangents
    w = jnp.linspace(0.5, 2.0, 16 * 64).reshape(16, 64).astype(jnp.float64)

    def loss(c):
        return jnp.sum(w * simulate_terminal_rows(key, c, **kw))

    want = np.asarray(jax.grad(loss)(arr))
    s_t = simulate_terminal_rows(key, arr, **kw)
    got = np.asarray(terminal_pathwise_vjp(w, s_t, arr))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_terminal_pathwise_vjp_matches_autodiff_antithetic_f32() -> None:
    from spectralmc_tpu.ops.gbm import simulate_terminal_rows
    from spectralmc_tpu.ops.gbm_pallas import terminal_pathwise_vjp

    key = jax.random.PRNGKey(4)
    arr = CONTRACT.as_array(jnp.float32)
    kw = dict(timesteps=4, rows=8, cols=128, dtype=jnp.float32,
              scheme=PathScheme.LOG_EULER, antithetic_half=4)
    w = jnp.ones((8, 128), jnp.float32) / (8 * 128)

    def loss(c):
        return jnp.sum(w * simulate_terminal_rows(key, c, **kw))

    want = np.asarray(jax.grad(loss)(arr))
    s_t = simulate_terminal_rows(key, arr, **kw)
    got = np.asarray(terminal_pathwise_vjp(w, s_t, arr))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def test_pallas_diff_wrapper_falls_back_and_differentiates() -> None:
    """Grads flow through the kernel's custom VJP (interpret mode), and off
    the GPU without interpret=True the wrapper refuses instead of falling
    back."""
    from spectralmc_tpu.ops.gbm_pallas import simulate_terminal_rows_pallas_diff

    key = jax.random.PRNGKey(2)
    arr = CONTRACT.as_array(jnp.float32)

    def mean_terminal(c):
        return jnp.mean(
            simulate_terminal_rows_pallas_diff(
                key, c, timesteps=4, rows=8, cols=128, dtype=jnp.float32,
                interpret=True,
            )
        )

    g = np.asarray(jax.grad(mean_terminal)(arr))
    with pytest.raises(ValueError, match="resolve_implementation"):
        simulate_terminal_rows_pallas_diff(
            key, arr, timesteps=4, rows=8, cols=128, dtype=jnp.float32
        )
    assert np.isfinite(g).all()
    assert g[0] > 0.0  # d E[S_T] / d S0 = e^{(r-q)T} > 0
    assert g[1] == 0.0  # strike never enters the simulator


def test_greeks_engine_selection() -> None:
    from spectralmc_tpu.ops.gbm import PayoffKind, SimImplementation
    from spectralmc_tpu.ops.greeks import greeks_engine
    from tests.helpers.factories import make_simulation_params

    xla = make_simulation_params(timesteps=4, network_size=128, batches_per_mc_run=8)
    assert greeks_engine(xla) == SimImplementation.XLA
    pal = make_simulation_params(
        timesteps=4, network_size=128, batches_per_mc_run=8,
        implementation=SimImplementation.PALLAS,
    )
    # off the GPU pallas_supported is False -> XLA; on the GPU it is PALLAS
    expected = (
        SimImplementation.PALLAS
        if jax.default_backend() == "gpu"
        else SimImplementation.XLA
    )
    assert greeks_engine(pal) == expected
    asian = make_simulation_params(
        timesteps=4, network_size=128, batches_per_mc_run=8,
        implementation=SimImplementation.PALLAS, payoff=PayoffKind.ASIAN_GEOMETRIC,
    )
    assert greeks_engine(asian) == SimImplementation.XLA


# --------------------------------------------------------------------------
# Round 3: basket kernel (structure under the interpreter + fallbacks)
# --------------------------------------------------------------------------

def _basket_spec():
    from spectralmc_tpu.ops.basket import BasketCombine, build_basket_spec

    return build_basket_spec(
        weights=(0.5, 0.3, 0.2),
        correlation=((1.0, 0.4, 0.2), (0.4, 1.0, 0.3), (0.2, 0.3, 1.0)),
        combine=BasketCombine.ARITHMETIC,
    ).expect("spec")


def test_basket_interpret_zero_normals_matches_closed_form() -> None:
    """Stubbed (all-zero) RNG: u1 = half-ulp, u2 = 0, so every draw yields
    (r, 0) with r = sqrt(-2 ln 2^-25); the mixed normal for asset a is
    r * sum of chol[a][b] over EVEN b <= a. The terminal basket value is then
    a deterministic closed form — a sharp check of the whole kernel skeleton
    (drift, mixing, combine) except the RNG distribution itself."""
    from spectralmc_tpu.ops.basket import basket_cholesky
    from spectralmc_tpu.ops.gbm import PayoffKind
    from spectralmc_tpu.ops.gbm_pallas import simulate_basket_underlier_rows_pallas

    spec = _basket_spec()
    key = jax.random.PRNGKey(1)
    c = CONTRACT
    arr = c.as_array(jnp.float32)
    T_STEPS, ROWS, COLS = 6, 8, 128
    with zero_bits():
        rows = simulate_basket_underlier_rows_pallas(
            key, arr, spec=spec, timesteps=T_STEPS, rows=ROWS, cols=COLS,
            dtype=jnp.float32, payoff=PayoffKind.TERMINAL, interpret=True,
        )
    t = np.asarray(rows)
    assert t.shape == (ROWS, COLS)
    assert np.all(np.isfinite(t)) and np.all(t > 0)
    assert np.allclose(t, t[0, 0], rtol=1e-5)  # zero-bit RNG -> identical paths

    r = np.sqrt(-2.0 * np.log(np.float32(2.0**-25)))
    chol = basket_cholesky(spec)
    dt = c.maturity / T_STEPS
    value = 0.0
    for a in range(3):
        sig = c.vol * spec.vol_multipliers[a]
        zm = r * sum(chol[a][b] for b in range(a + 1) if b % 2 == 0)
        logx = (
            np.log(c.spot * spec.spot_multipliers[a])
            + T_STEPS * (c.rate - c.div_yield - 0.5 * sig * sig) * dt
            + T_STEPS * sig * np.sqrt(dt) * zm
        )
        value += spec.weights[a] * np.exp(logx)
    assert t[0, 0] == pytest.approx(value, rel=1e-4)


def test_basket_pallas_fallback_matches_xla() -> None:
    """Odd shapes make the basket wrapper refuse (no silent XLA fallback)."""
    from spectralmc_tpu.ops.gbm import PayoffKind
    from spectralmc_tpu.ops.gbm_pallas import simulate_basket_underlier_rows_pallas

    spec = _basket_spec()
    key = jax.random.PRNGKey(5)
    arr = CONTRACT.as_array(jnp.float32)
    kw = dict(spec=spec, timesteps=2, rows=7, cols=100, dtype=jnp.float32,
              payoff=PayoffKind.ASIAN_ARITHMETIC)
    with pytest.raises(ValueError, match="basket"):
        simulate_basket_underlier_rows_pallas(key, arr, interpret=True, **kw)


def test_basket_pallas_resolves_and_dispatches() -> None:
    """resolve_implementation no longer short-circuits baskets to XLA; the
    dispatch seam selects the pallas function for PALLAS sims (which itself
    falls back off-TPU), and the stream-version table covers the family."""
    from spectralmc_tpu.ops.dispatch import make_underlier_simulator
    from spectralmc_tpu.ops.gbm import (
        ModelKind,
        SimImplementation,
        build_simulation_params,
        resolve_implementation,
    )
    from spectralmc_tpu.ops.gbm_pallas import pallas_stream_version

    spec = _basket_spec()
    sim = build_simulation_params(
        timesteps=2, network_size=128, batches_per_mc_run=8, mc_seed=1,
        model=ModelKind.BASKET_GBM, basket=spec,
        implementation=SimImplementation.PALLAS,
    ).expect("sim")
    expected = (
        SimImplementation.PALLAS
        if jax.default_backend() == "gpu"
        else SimImplementation.XLA
    )
    assert resolve_implementation(sim) == expected
    simulate = make_underlier_simulator(sim, rows=8)
    out = simulate(jax.random.PRNGKey(0), CONTRACT.as_array(jnp.float32))
    assert out.shape == (8, 128) and bool(jnp.isfinite(out).all())
    assert pallas_stream_version(ModelKind.BASKET_GBM) >= 1


# --------------------------------------------------------------------------
# Round 3: Merton kernel (in-register Poisson + structure + fallbacks)
# --------------------------------------------------------------------------


def _heston_contract():
    from spectralmc_tpu.ops.heston import HestonContract

    return HestonContract(
        spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
        v0=0.06, kappa=1.5, theta=0.05, xi=0.4, rho=-0.6,
    )


def _merton_contract():
    from spectralmc_tpu.ops.merton import MertonContract

    return MertonContract(
        spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
        vol=0.2, lam=0.5, jump_mean=-0.1, jump_std=0.25,
    )


@pytest.mark.parametrize("mu", [0.03, 0.5, 3.0])
def test_poisson_counts_exact_inverse_cdf(mu: float) -> None:
    """_poisson_counts is plain jax (runs anywhere): feed the EXACT uniform
    grid the 24-bit generator can emit and compare against the float64
    inverse CDF. The float32 scalar cdf recursion may disagree only where a
    uniform lands within one ulp of a cdf boundary — vanishingly rare and
    off by at most 1 count."""
    from spectralmc_tpu.ops.gbm_pallas import _poisson_counts

    n = 1 << 16
    k = np.arange(n, dtype=np.float64) / n
    u = jnp.asarray(k, jnp.float32)
    got = np.asarray(_poisson_counts(u, jnp.float32(mu)))
    # float64 reference inverse CDF
    pmf = [np.exp(-mu)]
    while sum(pmf) < 1.0 - 1e-12:
        pmf.append(pmf[-1] * mu / len(pmf))
    cdf = np.cumsum(pmf)
    want = np.searchsorted(cdf, k, side="right").astype(np.float64)
    mismatch = got != want
    assert mismatch.mean() < 1e-3, f"mu={mu}: {mismatch.mean():.2e} mismatch"
    assert np.abs(got[mismatch] - want[mismatch]).max(initial=0.0) <= 1.0
    # structural exactness at the ends
    assert got[k < np.exp(-mu) - 1e-6].max(initial=0.0) == 0.0
    assert float(_poisson_counts(jnp.zeros((4,), jnp.float32), jnp.float32(0.0)).max()) == 0.0


def test_merton_interpret_zero_bits_matches_closed_form() -> None:
    """Stubbed (all-zero) RNG: u1 = half-ulp -> radius r, u2 = 0 ->
    (sin, cos) = (0, 1) so z_d = r and z_j = 0; the count uniform is 0 <
    e^{-lam dt} so every count is 0 and the jump term vanishes. The terminal
    value is then the deterministic drift+diffusion closed form INCLUDING
    the -lam*m compensator — a sharp check of the whole kernel skeleton
    except the RNG distribution."""
    from spectralmc_tpu.ops.gbm import PayoffKind
    from spectralmc_tpu.ops.gbm_pallas import simulate_merton_underlier_rows_pallas

    c = _merton_contract()
    arr = c.as_array(jnp.float32)
    T_STEPS, ROWS, COLS = 6, 8, 128
    with zero_bits():
        rows = simulate_merton_underlier_rows_pallas(
            jax.random.PRNGKey(1), arr, timesteps=T_STEPS, rows=ROWS, cols=COLS,
            dtype=jnp.float32, payoff=PayoffKind.TERMINAL, interpret=True,
        )
    t = np.asarray(rows)
    assert t.shape == (ROWS, COLS)
    assert np.all(np.isfinite(t)) and np.allclose(t, t[0, 0], rtol=1e-5)
    r = np.sqrt(-2.0 * np.log(np.float32(2.0**-25)))
    dt = c.maturity / T_STEPS
    m = np.exp(c.jump_mean + 0.5 * c.jump_std**2) - 1.0
    drift = (c.rate - c.div_yield - c.lam * m - 0.5 * c.vol**2) * dt
    want = c.spot * np.exp(T_STEPS * (drift + c.vol * np.sqrt(dt) * r))
    assert t[0, 0] == pytest.approx(want, rel=1e-4)


def test_merton_pallas_fallback_matches_xla() -> None:
    """Odd shapes make the merton wrapper refuse (no silent XLA fallback)."""
    from spectralmc_tpu.ops.gbm import PayoffKind
    from spectralmc_tpu.ops.gbm_pallas import simulate_merton_underlier_rows_pallas

    arr = _merton_contract().as_array(jnp.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(timesteps=2, rows=7, cols=100, dtype=jnp.float32,
              payoff=PayoffKind.ASIAN_ARITHMETIC)
    with pytest.raises(ValueError, match="merton"):
        simulate_merton_underlier_rows_pallas(key, arr, interpret=True, **kw)


def test_merton_pallas_resolves_and_dispatches() -> None:
    """resolve_implementation no longer short-circuits merton to XLA; the
    dispatch seam selects the pallas function for PALLAS sims (which itself
    falls back off-TPU), and the stream-version table covers the family."""
    from spectralmc_tpu.ops.dispatch import make_underlier_simulator
    from spectralmc_tpu.ops.gbm import (
        ModelKind,
        SimImplementation,
        build_simulation_params,
        resolve_implementation,
    )
    from spectralmc_tpu.ops.gbm_pallas import pallas_stream_version

    sim = build_simulation_params(
        timesteps=2, network_size=128, batches_per_mc_run=8, mc_seed=1,
        model=ModelKind.MERTON_JUMP, implementation=SimImplementation.PALLAS,
    ).expect("sim")
    expected = (
        SimImplementation.PALLAS
        if jax.default_backend() == "gpu"
        else SimImplementation.XLA
    )
    assert resolve_implementation(sim) == expected
    simulate = make_underlier_simulator(sim, rows=8)
    out = simulate(jax.random.PRNGKey(0), _merton_contract().as_array(jnp.float32))
    assert out.shape == (8, 128) and bool(jnp.isfinite(out).all())
    assert pallas_stream_version(ModelKind.MERTON_JUMP) >= 1

# --------------------------------------------------------------------------
# Round 3: American monitor-row kernel (deterministic DP + fallbacks)
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "timesteps,every,side",
    [(8, 1, "call"), (8, 2, "call"), (6, 3, "call"), (8, 1, "put")],
)
def test_american_interpret_zero_bits_matches_deterministic_dp(
    timesteps: int, every: int, side: str
) -> None:
    """Stubbed (all-zero) RNG makes every path the SAME deterministic path
    (z = r per draw, r = sqrt(-2 ln 2^-25)), so the LSMC regression's
    continuation fit is exact (up to the relative ridge) and the Bermudan
    value reduces to the deterministic dynamic program
    v_d = max-if-ITM(payoff(S_d), disc * v_{d+1}) — a sharp host-replayable
    check of the monitor emission, segment pair-stepping, backward induction
    and the strike - cf/df encode, everything except the RNG distribution.
    The upward drift makes the put OTM everywhere (cf = 0, u = strike) —
    the ITM-masking edge."""
    from spectralmc_tpu.ops.gbm_pallas import simulate_american_underlier_rows_pallas
    from spectralmc_tpu.ops.greeks import OptionSide

    c = CONTRACT
    arr = c.as_array(jnp.float32)
    option = OptionSide.CALL if side == "call" else OptionSide.PUT
    with zero_bits():
        u = simulate_american_underlier_rows_pallas(
            jax.random.PRNGKey(1), arr, timesteps=timesteps, rows=8, cols=128,
            dtype=jnp.float32, option=option, exercise_every=every,
            interpret=True,
        )
    u = np.asarray(u)
    assert u.shape == (8, 128)
    assert np.all(np.isfinite(u)) and np.allclose(u, u[0, 0], rtol=1e-5)

    # host replay: per-segment increment = every*drift + n_draws*vol*sqrt(dt)*r
    r = np.sqrt(-2.0 * np.log(np.float32(2.0**-25)))
    dt = c.maturity / timesteps
    drift = (c.rate - c.div_yield - 0.5 * c.vol**2) * dt
    n_draws = every // 2 + every % 2
    seg = every * drift + n_draws * c.vol * np.sqrt(dt) * r
    n_mon = timesteps // every
    s = c.spot * np.exp(seg * np.arange(1, n_mon + 1))
    disc = np.exp(-c.rate * dt * every)

    def payoff(x: float) -> float:
        return max(x - c.strike, 0.0) if side == "call" else max(c.strike - x, 0.0)

    v = payoff(s[-1])
    for d in range(n_mon - 2, -1, -1):
        ex = payoff(s[d])
        v = ex if (ex > 0.0 and ex > disc * v) else disc * v
    expected = c.strike - (disc * v) / np.exp(-c.rate * c.maturity)
    assert u[0, 0] == pytest.approx(expected, rel=1e-4)


def test_american_pallas_fallback_matches_xla() -> None:
    """Off the GPU (without interpret) and at grids the kernel cannot run
    the wrapper refuses; in interpret mode antithetic + sparse grids run."""
    from spectralmc_tpu.ops.gbm_pallas import simulate_american_underlier_rows_pallas
    from spectralmc_tpu.ops.greeks import OptionSide

    arr = CONTRACT.as_array(jnp.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(
        timesteps=4, rows=8, cols=128, dtype=jnp.float32,
        option=OptionSide.PUT, exercise_every=2, antithetic_half=4,
    )
    with pytest.raises(ValueError, match="resolve_implementation"):
        simulate_american_underlier_rows_pallas(key, arr, **kw)
    with pytest.raises(ValueError, match="resolve_implementation"):
        simulate_american_underlier_rows_pallas(
            key, arr, **{**kw, "exercise_every": 4}, interpret=True
        )  # one monitor date
    out = np.asarray(simulate_american_underlier_rows_pallas(key, arr, interpret=True, **kw))
    assert out.shape == (8, 128) and np.isfinite(out).all()


def test_american_pallas_resolves_and_dispatches() -> None:
    """resolve_implementation no longer short-circuits GBM-American to XLA;
    the dispatch seam selects the pallas wrapper for PALLAS sims (which
    itself refuses off the GPU); non-GBM dynamics still resolve to XLA; and
    the American stream is versioned under its own key."""
    from spectralmc_tpu.ops.dispatch import make_underlier_simulator
    from spectralmc_tpu.ops.gbm import (
        ModelKind,
        PayoffKind,
        SimImplementation,
        build_simulation_params,
        resolve_implementation,
    )
    from spectralmc_tpu.ops.gbm_pallas import pallas_stream_version

    sim = build_simulation_params(
        timesteps=4, network_size=128, batches_per_mc_run=8, mc_seed=1,
        payoff=PayoffKind.AMERICAN_PUT, normalization="none",
        implementation=SimImplementation.PALLAS,
    ).expect("sim")
    expected = (
        SimImplementation.PALLAS
        if jax.default_backend() == "gpu"
        else SimImplementation.XLA
    )
    assert resolve_implementation(sim) == expected
    simulate = make_underlier_simulator(sim, rows=8)
    out = simulate(jax.random.PRNGKey(0), CONTRACT.as_array(jnp.float32))
    assert out.shape == (8, 128) and bool(jnp.isfinite(out).all())
    # separate stream key: an American rebuild never invalidates European
    # checkpoints and vice versa
    assert pallas_stream_version(ModelKind.GBM, PayoffKind.AMERICAN_PUT) >= 1
    assert pallas_stream_version(ModelKind.GBM) >= 1
    # Heston-American rides its own monitor kernel (two emitted state
    # row-sets) — same backend-dependent resolution as GBM
    heston_sim = build_simulation_params(
        timesteps=4, network_size=128, batches_per_mc_run=8, mc_seed=1,
        model=ModelKind.HESTON, payoff=PayoffKind.AMERICAN_PUT,
        normalization="none", implementation=SimImplementation.PALLAS,
    ).expect("heston sim")
    assert resolve_implementation(heston_sim) == expected


def test_american_monitor_block_vmem_budget() -> None:
    """The support predicate accepts power-of-two tiles and 2..128 monitor
    dates and rejects grids the kernel cannot honor."""
    from spectralmc_tpu.ops.gbm_pallas import _american_shape_ok

    kw = dict(dtype=jnp.float32, rows=4096, cols=256)
    assert _american_shape_ok(timesteps=16, exercise_every=1, **kw)
    assert _american_shape_ok(timesteps=256, exercise_every=2, **kw)
    assert not _american_shape_ok(timesteps=9, exercise_every=2, **kw)
    assert not _american_shape_ok(timesteps=4, exercise_every=4, **kw)
    assert not _american_shape_ok(timesteps=512, exercise_every=1, **kw)
    assert not _american_shape_ok(timesteps=16, exercise_every=1, dtype=jnp.float32,
                                  rows=12, cols=256)


# --------------------------------------------------------------------------
# Round 3: Heston/Merton/basket American monitor-row kernels
# --------------------------------------------------------------------------


def _deterministic_bermudan(s_path, strike, rate, dt_monitor, maturity, side):
    """Host Bellman DP over a deterministic monitor-date price path —
    exactly what the LSMC reduces to when every path is identical (the
    zero-bit interpreter stream). Returns the strike − cf/df encode."""
    disc = np.exp(-rate * dt_monitor)

    def payoff(x):
        return max(x - strike, 0.0) if side == "call" else max(strike - x, 0.0)

    v = payoff(s_path[-1])
    for d in range(len(s_path) - 2, -1, -1):
        ex = payoff(s_path[d])
        v = ex if (ex > 0.0 and ex > disc * v) else disc * v
    return strike - (disc * v) / np.exp(-rate * maturity)


def test_heston_american_interpret_zero_bits_matches_dp() -> None:
    """Zero-bit RNG: z_v = r (cos(0)=1), orthogonal part 0 — the Heston
    recursion is deterministic and host-replayable including the variance
    path; the variance-augmented regression on identical paths still
    reduces to the Bellman DP."""
    from spectralmc_tpu.ops.gbm_pallas import (
        simulate_heston_american_underlier_rows_pallas,
    )
    from spectralmc_tpu.ops.greeks import OptionSide

    c = _heston_contract()
    arr = c.as_array(jnp.float32)
    T_STEPS = 6
    with zero_bits():
        u = simulate_heston_american_underlier_rows_pallas(
            jax.random.PRNGKey(1), arr, timesteps=T_STEPS, rows=8, cols=128,
            dtype=jnp.float32, option=OptionSide.CALL, interpret=True,
        )
    u = np.asarray(u)
    assert u.shape == (8, 128)
    assert np.all(np.isfinite(u)) and np.allclose(u, u[0, 0], rtol=1e-5)

    r = np.sqrt(-2.0 * np.log(np.float32(2.0**-25)))
    dt = c.maturity / T_STEPS
    logx, v = np.log(c.spot), c.v0
    s_path = []
    for _ in range(T_STEPS):
        v_plus = max(v, 0.0)
        sv = np.sqrt(v_plus * dt)
        logx += (c.rate - c.div_yield) * dt - 0.5 * v_plus * dt + sv * c.rho * r
        v += c.kappa * c.theta * dt - c.kappa * dt * v_plus + c.xi * sv * r
        s_path.append(np.exp(logx))
    expected = _deterministic_bermudan(s_path, c.strike, c.rate, dt, c.maturity, "call")
    assert u[0, 0] == pytest.approx(expected, rel=1e-3)


def test_merton_american_interpret_zero_bits_matches_dp() -> None:
    """Zero-bit RNG: diffusion normal r, jump normal 0, count uniform 0 <
    e^{-lam dt} so counts are 0 — the jump term vanishes and the path is the
    compensated drift+diffusion closed form."""
    from spectralmc_tpu.ops.gbm_pallas import (
        simulate_merton_american_underlier_rows_pallas,
    )
    from spectralmc_tpu.ops.greeks import OptionSide

    c = _merton_contract()
    arr = c.as_array(jnp.float32)
    T_STEPS = 6
    with zero_bits():
        u = simulate_merton_american_underlier_rows_pallas(
            jax.random.PRNGKey(1), arr, timesteps=T_STEPS, rows=8, cols=128,
            dtype=jnp.float32, option=OptionSide.CALL, exercise_every=2,
            interpret=True,
        )
    u = np.asarray(u)
    assert np.all(np.isfinite(u)) and np.allclose(u, u[0, 0], rtol=1e-5)

    r = np.sqrt(-2.0 * np.log(np.float32(2.0**-25)))
    dt = c.maturity / T_STEPS
    m = np.exp(c.jump_mean + 0.5 * c.jump_std**2) - 1.0
    inc = (c.rate - c.div_yield - c.lam * m - 0.5 * c.vol**2) * dt + c.vol * np.sqrt(dt) * r
    s_path = [c.spot * np.exp(inc * t) for t in (2, 4, 6)]  # monitor dates
    expected = _deterministic_bermudan(
        s_path, c.strike, c.rate, 2 * dt, c.maturity, "call"
    )
    assert u[0, 0] == pytest.approx(expected, rel=1e-3)


@pytest.mark.parametrize("combine", ["arithmetic", "geometric"])
def test_basket_american_interpret_zero_bits_matches_dp(combine: str) -> None:
    """Zero-bit RNG: asset a's mixed normal is r * (sum of its even-index
    Cholesky row entries) — sin components are 0 — so every asset path and
    the combined basket are deterministic; the dispersion-augmented
    regression reduces to the Bellman DP on the basket value."""
    from spectralmc_tpu.ops.basket import (
        BasketCombine,
        basket_cholesky,
        build_basket_spec,
    )
    from spectralmc_tpu.ops.gbm_pallas import (
        simulate_basket_american_underlier_rows_pallas,
    )
    from spectralmc_tpu.ops.greeks import OptionSide

    spec = build_basket_spec(
        weights=(0.5, 0.3, 0.2),
        correlation=((1.0, 0.4, 0.2), (0.4, 1.0, 0.3), (0.2, 0.3, 1.0)),
        combine=(
            BasketCombine.ARITHMETIC if combine == "arithmetic"
            else BasketCombine.GEOMETRIC
        ),
    ).expect("spec")
    c = CONTRACT
    arr = c.as_array(jnp.float32)
    T_STEPS = 6
    with zero_bits():
        u = simulate_basket_american_underlier_rows_pallas(
            jax.random.PRNGKey(1), arr, spec=spec, timesteps=T_STEPS, rows=8,
            cols=128, dtype=jnp.float32, option=OptionSide.CALL, interpret=True,
        )
    u = np.asarray(u)
    assert np.all(np.isfinite(u)) and np.allclose(u, u[0, 0], rtol=1e-5)

    r = np.sqrt(-2.0 * np.log(np.float32(2.0**-25)))
    chol = basket_cholesky(spec)
    dt = c.maturity / T_STEPS
    logx = [np.log(c.spot * spec.spot_multipliers[a]) for a in range(3)]
    s_path = []
    for _ in range(T_STEPS):
        for a in range(3):
            sig = c.vol * spec.vol_multipliers[a]
            zm = r * sum(chol[a][b] for b in range(a + 1) if b % 2 == 0)
            logx[a] += (c.rate - c.div_yield - 0.5 * sig * sig) * dt + sig * np.sqrt(dt) * zm
        if combine == "geometric":
            s_path.append(np.exp(sum(spec.weights[a] * logx[a] for a in range(3))))
        else:
            s_path.append(sum(spec.weights[a] * np.exp(logx[a]) for a in range(3)))
    expected = _deterministic_bermudan(s_path, c.strike, c.rate, dt, c.maturity, "call")
    assert u[0, 0] == pytest.approx(expected, rel=1e-3)


@pytest.mark.parametrize("family", ["heston", "merton", "basket"])
def test_family_american_pallas_fallback_matches_xla(family: str) -> None:
    """Off the GPU every family-American wrapper refuses without
    interpret=True, and runs in interpret mode (antithetic + sparse monitor
    grid included)."""
    from spectralmc_tpu.ops import gbm_pallas as gp
    from spectralmc_tpu.ops.greeks import OptionSide

    key = jax.random.PRNGKey(5)
    kw = dict(
        timesteps=4, rows=8, cols=128, dtype=jnp.float32,
        option=OptionSide.PUT, exercise_every=2, antithetic_half=4,
    )
    if family == "heston":
        arr = _heston_contract().as_array(jnp.float32)
        fn = gp.simulate_heston_american_underlier_rows_pallas
    elif family == "merton":
        arr = _merton_contract().as_array(jnp.float32)
        fn = gp.simulate_merton_american_underlier_rows_pallas
    else:
        arr = CONTRACT.as_array(jnp.float32)
        fn = functools.partial(
            gp.simulate_basket_american_underlier_rows_pallas, spec=_basket_spec()
        )
    with pytest.raises(ValueError, match="resolve_implementation"):
        fn(key, arr, **kw)
    out = np.asarray(fn(key, arr, interpret=True, **kw))
    assert out.shape == (8, 128) and np.isfinite(out).all()


def test_family_american_dispatch_selects_pallas_wrappers() -> None:
    """The dispatch seam routes PALLAS American sims of every dynamics
    through the monitor-row wrappers (which refuse off the GPU), and each
    family's American stream has its own version key."""
    from spectralmc_tpu.ops.dispatch import make_underlier_simulator
    from spectralmc_tpu.ops.gbm import (
        ModelKind,
        PayoffKind,
        SimImplementation,
        build_simulation_params,
    )
    from spectralmc_tpu.ops.gbm_pallas import pallas_stream_version

    for model, extra in (
        (ModelKind.HESTON, {}),
        (ModelKind.MERTON_JUMP, {}),
        (ModelKind.BASKET_GBM, {"basket": _basket_spec()}),
    ):
        sim = build_simulation_params(
            timesteps=4, network_size=128, batches_per_mc_run=8, mc_seed=1,
            model=model, payoff=PayoffKind.AMERICAN_PUT, normalization="none",
            implementation=SimImplementation.PALLAS, **extra,
        ).expect("sim")
        simulate = make_underlier_simulator(sim, rows=8)
        if model == ModelKind.HESTON:
            arr = _heston_contract().as_array(jnp.float32)
        elif model == ModelKind.MERTON_JUMP:
            arr = _merton_contract().as_array(jnp.float32)
        else:
            arr = CONTRACT.as_array(jnp.float32)
        out = simulate(jax.random.PRNGKey(0), arr)
        assert out.shape == (8, 128) and bool(jnp.isfinite(out).all()), model
        assert pallas_stream_version(model, PayoffKind.AMERICAN_PUT) >= 1


# --------------------------------------------------------------------------
# Round 3: term-structure kernel (stream gbm_term v1)
# --------------------------------------------------------------------------


from spectralmc_tpu.ops.gbm import PayoffKind  # noqa: E402


def _term_curved():
    from spectralmc_tpu.ops.gbm import TermStructure

    T = 8
    return TermStructure(
        vol_shape=tuple(1.5 - 1.0 * i / T for i in range(T)),
        rate_shape=tuple(0.5 + 1.0 * i / T for i in range(T)),
    )


def test_term_interpret_zero_bits_matches_phase_identity() -> None:
    """Zero-bit RNG makes the term kernel a deterministic recursion we can
    replay host-side with the MODULE'S OWN scalar helpers: each pair adds
    (d_a + d_b) + r0 * R_p * sin_turns(phi_p) — a sharp gate on the coefficient
    table plumbing and the phase-shift pair identity, independent of the
    RNG distribution."""
    from spectralmc_tpu.ops.gbm_pallas import (
        _bm_radius,
        _sin_turns,
        _term_coeff_tables,
        simulate_underlier_rows_pallas,
    )

    term = _term_curved()
    arr = CONTRACT.as_array(jnp.float32)
    T = 8
    with zero_bits():
        rows = simulate_underlier_rows_pallas(
            jax.random.PRNGKey(1), arr, timesteps=T, rows=8, cols=128,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
            payoff=PayoffKind.TERMINAL, term=term, interpret=True,
        )
    t = np.asarray(rows)
    assert t.shape == (8, 128) and np.all(np.isfinite(t)) and np.all(t > 0)
    assert np.allclose(t, t[0, 0])  # zero-bit RNG -> identical paths
    step, pair = _term_coeff_tables(arr, term.shapes(T), T)
    r0 = float(_bm_radius(jnp.float32(2.0**-25)))
    logx = float(jnp.log(arr[0]))
    for p in range(T // 2):
        logx += float(step[2 * p, 0] + step[2 * p + 1, 0])
        logx += r0 * float(pair[p, 0]) * float(_sin_turns(pair[p, 1]))
    np.testing.assert_allclose(t[0, 0], np.exp(np.float32(logx)), rtol=1e-5)


def test_term_interpret_zero_bits_asian_and_barrier() -> None:
    """Per-step branches: the Asian accumulator and the barrier running
    extreme consume step_ref[t] singles — replay the deterministic skeleton
    host-side."""
    from spectralmc_tpu.ops.gbm_pallas import (
        _bm_radius,
        _sin_turns,
        _term_coeff_tables,
        simulate_underlier_rows_pallas,
    )

    term = _term_curved()
    arr = CONTRACT.as_array(jnp.float32)
    T = 8
    step, _ = _term_coeff_tables(arr, term.shapes(T), T)
    r0 = float(_bm_radius(jnp.float32(2.0**-25)))
    z0 = r0 * float(_sin_turns(jnp.float32(0.25)))
    logs = []
    logx = float(jnp.log(arr[0]))
    for t_i in range(T):
        logx += float(step[t_i, 0]) + float(step[t_i, 1]) * z0
        logs.append(logx)
    with zero_bits():
        asian = simulate_underlier_rows_pallas(
            jax.random.PRNGKey(1), arr, timesteps=T, rows=8, cols=128,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
            payoff=PayoffKind.ASIAN_GEOMETRIC, term=term, interpret=True,
        )
    want_geo = np.exp(np.mean(np.asarray(logs, dtype=np.float64)))
    np.testing.assert_allclose(float(asian[0, 0]), want_geo, rtol=1e-5)
    # barrier far above any zero-bit path: terminal value survives
    with zero_bits():
        barrier = simulate_underlier_rows_pallas(
            jax.random.PRNGKey(1), arr, timesteps=T, rows=8, cols=128,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
            payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=1e6,
            term=term, interpret=True,
        )
    np.testing.assert_allclose(float(barrier[0, 0]), np.exp(logs[-1]), rtol=1e-5)


def test_term_flat_curves_take_the_flat_kernel_bitstream() -> None:
    """An exactly-flat TermStructure through the pallas wrapper is the SAME
    program as no term — bit-identical output, no gbm_term stream."""
    from spectralmc_tpu.ops.gbm import TermStructure
    from spectralmc_tpu.ops.gbm_pallas import simulate_underlier_rows_pallas

    arr = CONTRACT.as_array(jnp.float32)
    flat_term = TermStructure(vol_shape=(1.0,) * 8, rate_shape=(1.0,) * 8)
    with zero_bits():
        base = simulate_underlier_rows_pallas(
            jax.random.PRNGKey(2), arr, timesteps=8, rows=8, cols=128,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
            payoff=PayoffKind.TERMINAL, interpret=True,
        )
        with_term = simulate_underlier_rows_pallas(
            jax.random.PRNGKey(2), arr, timesteps=8, rows=8, cols=128,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
            payoff=PayoffKind.TERMINAL, term=flat_term, interpret=True,
        )
    assert np.array_equal(np.asarray(base), np.asarray(with_term))


def test_term_pallas_fallback_matches_xla() -> None:
    """Off the GPU (no interpret) the term wrapper refuses; the reflection-
    Euler scheme under a curved term has no kernel and refuses everywhere."""
    from spectralmc_tpu.ops.gbm_pallas import simulate_underlier_rows_pallas

    term = _term_curved()
    arr = CONTRACT.as_array(jnp.float32)
    kw = dict(
        timesteps=8, rows=8, cols=128, dtype=jnp.float32,
        scheme=PathScheme.LOG_EULER, payoff=PayoffKind.ASIAN_ARITHMETIC,
    )
    with pytest.raises(ValueError, match="resolve_implementation"):
        simulate_underlier_rows_pallas(jax.random.PRNGKey(3), arr, term=term, **kw)
    with pytest.raises(ValueError, match="resolve_implementation"):
        simulate_underlier_rows_pallas(
            jax.random.PRNGKey(3), arr, term=term, interpret=True,
            **{**kw, "scheme": PathScheme.EULER},
        )


def test_term_antithetic_in_block_mirroring() -> None:
    """With antithetic on, each odd row mirrors its even partner's normals
    negated — under the zero-bit stream even and odd rows are the two
    deterministic +/- z0 paths."""
    from spectralmc_tpu.ops.gbm_pallas import (
        _bm_radius,
        _sin_turns,
        _term_coeff_tables,
        simulate_underlier_rows_pallas,
    )

    term = _term_curved()
    arr = CONTRACT.as_array(jnp.float32)
    T = 8
    with zero_bits():
        rows = simulate_underlier_rows_pallas(
            jax.random.PRNGKey(1), arr, timesteps=T, rows=8, cols=128,
            dtype=jnp.float32, scheme=PathScheme.LOG_EULER,
            payoff=PayoffKind.ASIAN_GEOMETRIC, term=term,
            antithetic_half=4, interpret=True,
        )
    t = np.asarray(rows)
    step, _ = _term_coeff_tables(arr, term.shapes(T), T)
    r0 = float(_bm_radius(jnp.float32(2.0**-25)))
    z0 = r0 * float(_sin_turns(jnp.float32(0.25)))
    for sign, row in ((1.0, 0), (-1.0, 1)):
        logx = float(jnp.log(arr[0]))
        acc = 0.0
        for t_i in range(T):
            logx += float(step[t_i, 0]) + float(step[t_i, 1]) * sign * z0
            acc += logx
        np.testing.assert_allclose(t[row, 0], np.exp(acc / T), rtol=1e-5)
    assert not np.allclose(t[0, 0], t[1, 0])


def test_term_stream_version_and_resolution() -> None:
    """Curved terms carry their own stream key; flat terms do not. Off the
    GPU resolution is XLA (pallas_supported needs the card)."""
    from spectralmc_tpu.ops.gbm import (
        ModelKind,
        SimImplementation,
        build_simulation_params,
        resolve_implementation,
    )
    from spectralmc_tpu.ops.gbm_pallas import pallas_stream_version

    # the Triton kernels' in-kernel threefry stream bumped every key
    assert pallas_stream_version(ModelKind.GBM, term=True) == 2
    assert pallas_stream_version(ModelKind.GBM, term=False) == 3
    sim = build_simulation_params(
        timesteps=8, network_size=128, batches_per_mc_run=8, mc_seed=1,
        implementation=SimImplementation.PALLAS, term=_term_curved(),
    ).expect("sim")
    assert resolve_implementation(sim) == SimImplementation.XLA  # off the GPU


def test_terminal_pathwise_vjp_term_matches_autodiff() -> None:
    """The effective-factor generalization of the pathwise rule must equal
    jax.grad of the XLA simulator WITH the term threaded — verifying the
    Pallas engine's curved-market backward pass off-TPU."""
    from spectralmc_tpu.ops.gbm import simulate_terminal_rows
    from spectralmc_tpu.ops.gbm_pallas import terminal_pathwise_vjp

    term = _term_curved()
    T = 8
    vs, rs, qs = term.shapes(T)
    factors = (
        sum(v * v for v in vs) / T,
        sum(rs) / T,
        sum(qs) / T,
    )
    key = jax.random.PRNGKey(9)
    arr = CONTRACT.as_array(jnp.float64)
    kw = dict(timesteps=T, rows=16, cols=64, dtype=jnp.float64,
              scheme=PathScheme.LOG_EULER, term=term)
    w = jnp.linspace(0.5, 2.0, 16 * 64).reshape(16, 64).astype(jnp.float64)

    def loss(c):
        return jnp.sum(w * simulate_terminal_rows(key, c, **kw))

    want = np.asarray(jax.grad(loss)(arr))
    s_t = simulate_terminal_rows(key, arr, **kw)
    got = np.asarray(terminal_pathwise_vjp(w, s_t, arr, factors))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_greeks_engine_keeps_pallas_under_term() -> None:
    """greeks_engine no longer downgrades curved-term sims; mc_greeks through
    the (off-TPU fallback) diff wrapper matches the XLA IPA estimator."""
    from spectralmc_tpu.ops.gbm import (
        SimImplementation,
        build_simulation_params,
    )
    from spectralmc_tpu.ops.greeks import OptionSide, greeks_engine, mc_greeks

    sim = build_simulation_params(
        timesteps=8, network_size=128, batches_per_mc_run=16, mc_seed=3,
        implementation=SimImplementation.PALLAS, term=_term_curved(),
    ).expect("sim")
    # off-TPU pallas_supported is False -> the XLA engine actually runs,
    # but the SELECTION no longer special-cases term
    g = mc_greeks(sim, CONTRACT, option=OptionSide.PUT)
    assert g.engine == greeks_engine(sim)
    xla_sim = sim.model_copy(update={"implementation": SimImplementation.XLA})
    g2 = mc_greeks(xla_sim, CONTRACT, option=OptionSide.PUT)
    for field in ("spot", "strike", "maturity", "rate", "div_yield", "vol"):
        np.testing.assert_allclose(
            g.by_field[field], g2.by_field[field], rtol=1e-5, atol=1e-7
        )


# --------------------------------------------------------------------------
# Stream addressing across every kernel: the same draws whatever the block
# shape or the shard's row offset
# --------------------------------------------------------------------------


def _family_runner(kind: str):
    """(fn, contract) for one kernel: fn(key, arr, rows=, row_offset=) runs it
    in interpret mode at 16 x 256, 8 steps, antithetic on."""
    from spectralmc_tpu.ops import gbm_pallas as gp
    from spectralmc_tpu.ops.gbm import PayoffKind
    from spectralmc_tpu.ops.greeks import OptionSide

    base = dict(timesteps=8, cols=256, dtype=jnp.float32, interpret=True)
    flat = functools.partial(
        gp.simulate_underlier_rows_pallas, scheme=PathScheme.LOG_EULER, **base
    )
    american = dict(option=OptionSide.PUT, exercise_every=2, **base)
    table = {
        "gbm_terminal": (functools.partial(flat, payoff=PayoffKind.TERMINAL), CONTRACT),
        "gbm_asian": (functools.partial(flat, payoff=PayoffKind.ASIAN_ARITHMETIC), CONTRACT),
        "gbm_barrier": (
            functools.partial(flat, payoff=PayoffKind.BARRIER_UP_OUT, barrier_rel=1.2),
            CONTRACT,
        ),
        "gbm_variance": (functools.partial(flat, payoff=PayoffKind.VARIANCE_SWAP), CONTRACT),
        "gbm_cliquet": (
            functools.partial(
                flat, payoff=PayoffKind.CLIQUET, cliquet_reset_every=2,
                cliquet_floor=-0.05, cliquet_cap=0.05,
            ),
            CONTRACT,
        ),
        "gbm_term": (
            functools.partial(flat, payoff=PayoffKind.TERMINAL, term=_term_curved()),
            CONTRACT,
        ),
        "gbm_euler": (
            functools.partial(
                gp.simulate_underlier_rows_pallas, scheme=PathScheme.EULER,
                payoff=PayoffKind.TERMINAL, **base,
            ),
            CONTRACT,
        ),
        "heston": (
            functools.partial(
                gp.simulate_heston_underlier_rows_pallas, payoff=PayoffKind.TERMINAL, **base
            ),
            _heston_contract(),
        ),
        "merton": (
            functools.partial(
                gp.simulate_merton_underlier_rows_pallas, payoff=PayoffKind.TERMINAL, **base
            ),
            _merton_contract(),
        ),
        "basket": (
            functools.partial(
                gp.simulate_basket_underlier_rows_pallas, spec=_basket_spec(),
                payoff=PayoffKind.TERMINAL, **base,
            ),
            CONTRACT,
        ),
        "american_gbm": (
            functools.partial(gp.simulate_american_underlier_rows_pallas, **american),
            CONTRACT,
        ),
        "american_heston": (
            functools.partial(gp.simulate_heston_american_underlier_rows_pallas, **american),
            _heston_contract(),
        ),
        "american_merton": (
            functools.partial(gp.simulate_merton_american_underlier_rows_pallas, **american),
            _merton_contract(),
        ),
        "american_basket": (
            functools.partial(
                gp.simulate_basket_american_underlier_rows_pallas, spec=_basket_spec(),
                **american,
            ),
            CONTRACT,
        ),
    }
    fn, contract = table[kind]
    return fn, contract.as_array(jnp.float32)


KERNEL_KINDS = [
    "gbm_terminal", "gbm_asian", "gbm_barrier", "gbm_variance", "gbm_cliquet",
    "gbm_term", "gbm_euler", "heston", "merton", "basket",
]


@pytest.mark.parametrize("kind", KERNEL_KINDS + ["american_gbm", "american_basket"])
def test_every_kernel_stream_independent_of_block_shape(
    monkeypatch: pytest.MonkeyPatch, kind: str
) -> None:
    """Each kernel emits the same values under two different tilings: its
    draws are addressed by (key, global row, global column, draw index)."""
    from spectralmc_tpu.ops import gbm_pallas as gp

    fn, arr = _family_runner(kind)
    key = jax.random.PRNGKey(11)
    outs = []
    for block in ((8, 128), (4, 64)):
        monkeypatch.setattr(gp, "BLOCK_ROWS", block[0])
        monkeypatch.setattr(gp, "BLOCK_COLS", block[1])
        jax.clear_caches()
        outs.append(np.asarray(fn(key, arr, rows=16, antithetic_half=8)))
    jax.clear_caches()
    assert np.isfinite(outs[0]).all()
    if kind.startswith("american"):
        # the LSMC regression reduces over the block-independent rows in
        # the same order; only the forward tiling changed
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6)
    else:
        np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("kind", KERNEL_KINDS)
def test_every_kernel_shard_reproduces_global_rows(kind: str) -> None:
    """A shard running rows [8, 16) with row_offset=8 reproduces exactly the
    unsharded kernel's rows 8..15 (antithetic pairs included)."""
    fn, arr = _family_runner(kind)
    key = jax.random.PRNGKey(13)
    full = np.asarray(fn(key, arr, rows=16, antithetic_half=8))
    hi = np.asarray(fn(key, arr, rows=8, row_offset=8, antithetic_half=4))
    np.testing.assert_array_equal(hi, full[8:])


def test_pallas_supported_needs_gpu_and_pow2_tiles(monkeypatch: pytest.MonkeyPatch) -> None:
    """The support predicate admits the GPU at power-of-two tilings only."""
    from spectralmc_tpu.ops import gbm_pallas as gp

    assert not gp.pallas_supported(dtype=jnp.float32, rows=2048, cols=512)  # CPU
    monkeypatch.setattr(gp.jax, "default_backend", lambda: "gpu")
    assert gp.pallas_supported(dtype=jnp.float32, rows=2048, cols=512)
    assert gp.pallas_supported(dtype=jnp.float32, rows=2, cols=32)  # tiny tiles
    assert not gp.pallas_supported(dtype=jnp.float64, rows=2048, cols=512)
    assert not gp.pallas_supported(dtype=jnp.float32, rows=12, cols=512)
    assert not gp.pallas_supported(dtype=jnp.float32, rows=2048, cols=96)
    assert gp.pallas_american_supported(
        dtype=jnp.float32, rows=2048, cols=512, timesteps=16, exercise_every=1
    )


@pytest.mark.parametrize(
    "overrides,engine",
    [
        ({}, "pallas"),
        ({"model": "heston"}, "pallas"),
        ({"model": "merton_jump"}, "pallas"),
        ({"payoff": "american_put", "normalization": "none"}, "pallas"),
        ({"scheme": "euler", "payoff": "cliquet", "cliquet_reset_every": 2,
          "cliquet_floor": -0.05, "cliquet_cap": 0.05, "normalization": "none"}, "xla"),
        ({"precision": "float64"}, "xla"),
    ],
)
def test_resolve_implementation_on_gpu(
    monkeypatch: pytest.MonkeyPatch, overrides: dict, engine: str
) -> None:
    """On a GPU backend resolve_implementation routes PALLAS sims to the
    kernels wherever one exists, and to XLA where none does."""
    from spectralmc_tpu.ops import gbm_pallas as gp
    from spectralmc_tpu.ops.gbm import (
        SimImplementation,
        build_simulation_params,
        resolve_implementation,
    )

    if overrides.get("precision") == "float64":
        jax.config.update("jax_enable_x64", True)
    sim = build_simulation_params(
        timesteps=8, network_size=128, batches_per_mc_run=8, mc_seed=1,
        implementation="pallas", **overrides,
    ).expect("sim")
    monkeypatch.setattr(gp.jax, "default_backend", lambda: "gpu")
    assert resolve_implementation(sim) == SimImplementation(engine)
