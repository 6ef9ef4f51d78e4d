#!/usr/bin/env python3
"""Smoke test of the main path on one NVIDIA GPU.

Drives ``GbmCVNNPricer.create -> train -> snapshot -> create(snapshot) ->
predict_price / predict_greeks`` at the full width of BASELINE config 3
(1,048,576 paths per contract, 512-point FFT, deep 256-wide CVNN) on the
fused Pallas kernels, checks every kernel family against its closed-form or
lattice oracle and against the XLA scan, and times each kernel against the
XLA scan of the same family.

    python chip_smoke.py               # one card, every phase
    python chip_smoke.py --four-cards  # four local cards: the sharded phase only

There is no CPU fallback: without a GPU it exits non-zero and prints no
result. Every line but the last names the card and its power limit; the
last line is one JSON object. Run one JAX process per card: a process
reserves most of the card's memory when it starts.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

WIDTH = dict(timesteps=16, network_size=512, batches_per_mc_run=2048)
# bench.py's kernel shapes: flat families, the basket, the American families
FLAT_SHAPE = dict(timesteps=64, network_size=256, batches_per_mc_run=8192)
BASKET_SHAPE = dict(timesteps=64, network_size=256, batches_per_mc_run=2048)
AMERICAN_SHAPE = dict(timesteps=16, network_size=256, batches_per_mc_run=4096)


def card_name_and_limit() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi listed no card")
    return out[0].strip()


class Log:
    def __init__(self, card: str) -> None:
        self.card = card

    def __call__(self, phase: str, msg: str) -> None:
        print(f"[{self.card}] {phase}: {msg}", flush=True)


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------


def gbm_bounds() -> dict:
    from spectralmc_tpu.ops.sobol import BoundSpec

    return {
        "spot": BoundSpec(lower=80.0, upper=120.0),
        "strike": BoundSpec(lower=80.0, upper=120.0),
        "maturity": BoundSpec(lower=0.25, upper=2.0),
        "rate": BoundSpec(lower=0.0, upper=0.08),
        "div_yield": BoundSpec(lower=0.0, upper=0.04),
        "vol": BoundSpec(lower=0.15, upper=0.45),
    }


def baseline3_config(
    implementation: str, *, width: int = 256, batch_norm: bool = True, **sim_overrides
):
    """BASELINE config 3 as bench.py builds it: deep CVNN (Linear-256-modReLU,
    covariance BN, a residual block of two 256-wide linears). ``batch_norm=
    False`` drops the BN layer, whose statistics are per shard on a mesh."""
    from spectralmc_tpu.models.factory import (
        Activation,
        CovBNCfg,
        LinearCfg,
        ResidualCfg,
        SequentialCfg,
        build_cvnn_config,
    )
    from spectralmc_tpu.ops.gbm import build_simulation_params
    from spectralmc_tpu.training.trainer import GbmCVNNPricerConfig

    sim = build_simulation_params(
        **{**WIDTH, **sim_overrides}, mc_seed=7, implementation=implementation
    ).expect("sim")
    cvnn = build_cvnn_config(
        layers=[
            LinearCfg(width=width, activation=Activation.MODRELU),
            *([CovBNCfg()] if batch_norm else []),
            ResidualCfg(
                body=SequentialCfg(
                    layers=(
                        LinearCfg(width=width, activation=Activation.ZRELU),
                        LinearCfg(width=width, activation=Activation.NONE),
                    )
                ),
                activation=Activation.MODRELU,
            ),
        ],
        seed=11,
    ).expect("cvnn")
    return GbmCVNNPricerConfig(sim=sim, bounds=gbm_bounds(), cvnn=cvnn)


def training(num_batches: int, batch_size: int = 512, chunk: int | None = 256):
    from spectralmc_tpu.training.trainer import build_training_config

    return build_training_config(
        num_batches=num_batches, batch_size=batch_size, learning_rate=1e-3,
        contract_chunk=chunk,
    ).expect("training config")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device(log: Log, cache_dir: str) -> None:
    import jax

    log("device", f"jax.devices()={jax.devices()}")
    log("device", f"jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}")
    log("device", f"matmul precision={jax.config.jax_default_matmul_precision}, "
        f"compile cache={cache_dir}")


def phase_train(log: Log) -> dict:
    """Train 3 steps on the kernel, resume from the snapshot, predict."""
    import numpy as np

    from spectralmc_tpu.ops.gbm import SimImplementation
    from spectralmc_tpu.ops.gbm_pallas import pallas_stream_version
    from spectralmc_tpu.training.trainer import GbmCVNNPricer

    pricer = GbmCVNNPricer.create(baseline3_config("pallas")).expect("create")
    steps3 = training(3)
    start = time.perf_counter()
    first = pricer.train(steps3).expect("train")
    first_s = time.perf_counter() - start
    snap = pricer.snapshot()
    assert snap.sim.implementation == SimImplementation.PALLAS, snap.sim.implementation
    assert snap.pallas_stream_version == pallas_stream_version(snap.sim.model, snap.sim.payoff)
    assert np.isfinite(first.losses).all(), first.losses
    log("train", f"3 steps x {steps3.batch_size} contracts x "
        f"{WIDTH['batches_per_mc_run'] * WIDTH['network_size']}"
        f" paths x {WIDTH['timesteps']} steps, engine={snap.sim.implementation.value} "
        f"stream v{snap.pallas_stream_version}, losses={first.losses.tolist()}, "
        f"first call incl. compile {first_s:.1f} s")

    restored = GbmCVNNPricer.create(snap).expect("create(snapshot)")
    a = pricer.train(training(2)).expect("train a").losses
    b = restored.train(training(2)).expect("train b").losses
    assert np.array_equal(a, b), f"resume is not bit-exact: {a.tolist()} vs {b.tolist()}"
    sa, sb = pricer.snapshot(), restored.snapshot()
    for key in sa.model_state:
        assert np.array_equal(sa.model_state[key], sb.model_state[key]), key
    log("resume", f"2 more steps on both: losses bit-equal {a.tolist()}, "
        f"model state bit-equal ({len(sa.model_state)} tensors)")

    times = []
    for _ in range(3):
        start = time.perf_counter()
        pricer.train(training(2)).expect("timed train")
        times.append((time.perf_counter() - start) / 2)
    step_s = statistics.median(times)
    log("train", f"step time (kernel engine, median of 3 calls of 2 steps) "
        f"{step_s * 1e3:.2f} ms")
    phase_predict(log, pricer)
    return {"pallas_step_s": step_s}


def phase_predict(log: Log, pricer) -> None:
    import numpy as np

    from spectralmc_tpu.ops.gbm import BlackScholesContract

    rng = np.random.default_rng(3)
    bounds = gbm_bounds()
    for n in (1, 37, 256):
        contracts = [
            BlackScholesContract(**{
                f: float(rng.uniform(b.lower, b.upper)) for f, b in bounds.items()
            })
            for _ in range(n)
        ]
        price = pricer.predict_price(contracts, pad_to_bucket=True)
        greeks = pricer.predict_greeks(contracts, pad_to_bucket=True)
        for name in ("put", "call"):
            assert getattr(price, name).shape == (n,)
            assert np.isfinite(getattr(price, name)).all(), name
        for name in ("put_jacobian", "call_jacobian", "put_gamma", "call_gamma"):
            assert np.isfinite(getattr(greeks, name)).all(), name
        # two programs (the greeks one differentiates): equal to rounding
        put_gap = float(np.max(np.abs(greeks.put - price.put)))
        assert put_gap <= 1e-5 * float(np.max(np.abs(price.put)) + 1.0), put_gap
        s, k, t, r, q = (np.array([getattr(c, f) for c in contracts]) for f in
                         ("spot", "strike", "maturity", "rate", "div_yield"))
        parity = np.exp(-r * t) * (s * np.exp((r - q) * t) - k)
        gap = float(np.max(np.abs((price.call - price.put) - parity)))
        assert gap < 2e-4 * float(np.max(s)), gap
        log("predict", f"batch {n}: prices and greeks finite, "
            f"max |call - put - df(F - K)| = {gap:.3e}, "
            f"max |greeks.put - price.put| = {put_gap:.3e}")


def _payoffs(u, strike: float, df: float):
    import numpy as np

    return df * np.maximum(strike - u, 0.0), df * np.maximum(u - strike, 0.0)


def _mean_se(x) -> tuple[float, float]:
    return float(x.mean()), float(x.std(ddof=1) / math.sqrt(x.size))


def simulate(sim, contract, seed: int = 5):
    """Underliers of one contract through the router the trainer uses."""
    import jax
    import numpy as np

    from spectralmc_tpu.ops.dispatch import make_underlier_simulator

    fn = jax.jit(make_underlier_simulator(sim, rows=sim.batches_per_mc_run))
    out = fn(jax.random.PRNGKey(seed), contract, 0)
    return np.asarray(out, np.float64).ravel()


def reference_cases():
    """(name, sim overrides, contract array, check) per kernel family; check
    takes the underliers of each engine and returns (message, ok)."""
    import jax.numpy as jnp
    import numpy as np

    from spectralmc_tpu.ops.american import bermudan_tree_price
    from spectralmc_tpu.ops.analytic import (
        black_scholes_price,
        cliquet_price,
        geometric_basket_price,
        term_effective_black,
    )
    from spectralmc_tpu.ops.basket import build_basket_spec, geometric_basket_effective_gbm
    from spectralmc_tpu.ops.gbm import TermStructure
    from spectralmc_tpu.ops.heston import heston_call_price
    from spectralmc_tpu.ops.merton import merton_call_price

    gbm = (100.0, 100.0, 1.0, 0.03, 0.01, 0.25)
    heston = dict(spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.01,
                  v0=0.04, kappa=1.5, theta=0.04, xi=0.5, rho=-0.7)
    merton = dict(spot=100.0, strike=100.0, maturity=1.0, rate=0.03, div_yield=0.0,
                  vol=0.2, lam=0.5, jump_mean=-0.1, jump_std=0.15)
    spec = build_basket_spec(
        weights=(0.5, 0.3, 0.2),
        correlation=((1.0, 0.4, 0.2), (0.4, 1.0, 0.3), (0.2, 0.3, 1.0)),
        combine="geometric",
    ).expect("spec")
    T = WIDTH["timesteps"]
    term = TermStructure(
        vol_shape=tuple(1.5 - 1.0 * i / T for i in range(T)),
        rate_shape=tuple(0.5 + 1.0 * i / T for i in range(T)),
    )
    arr = lambda xs: jnp.asarray(xs, jnp.float32)  # noqa: E731

    def z_both(exact_put: float, exact_call: float, strike: float, df: float):
        def check(u):
            put, call = _payoffs(u, strike, df)
            (pm, ps), (cm, cs) = _mean_se(put), _mean_se(call)
            zp, zc = (pm - exact_put) / ps, (cm - exact_call) / cs
            return (f"put {pm:.5f} vs {exact_put:.5f} (z={zp:+.2f}), "
                    f"call {cm:.5f} vs {exact_call:.5f} (z={zc:+.2f})",
                    abs(zp) < 4 and abs(zc) < 4)
        return check

    def american(exact: float, strike: float, df: float):
        def check(u):
            m, se = _mean_se(_payoffs(u, strike, df)[0])
            tol = max(4 * se, 0.01 * exact)
            return (f"{m:.5f} vs {exact:.5f} (|gap| {abs(m - exact):.5f} <= "
                    f"max(4 SE, 1%) = {tol:.5f})", abs(m - exact) <= tol)
        return check

    s, k, t, r, q, v = gbm
    df = math.exp(-r * t)
    bs = black_scholes_price(*gbm)
    cq = cliquet_price(s, 0.05, t, r, q, v, timesteps=T, reset_every=4,
                       local_floor=0.0, local_cap=0.08)
    vs, rs, qs = term.shapes(T)
    tb = term_effective_black(*gbm, vol_shape=vs, rate_shape=rs, div_shape=qs)
    df_term = math.exp(-r * t * float(np.mean(rs)))
    gb = geometric_basket_price(*gbm, spec=spec)
    m_call, m_put = merton_call_price(**merton)
    h_call, h_put = heston_call_price(**heston)
    g0, vol_eff, div_eff = geometric_basket_effective_gbm(
        jnp.asarray(gbm, jnp.float64), spec
    )
    tree = dict(maturity=t, rate=r, exercise_dates=T, option="put")
    none = dict(normalization="none")
    return [
        ("gbm", {}, arr(gbm), z_both(float(bs.put), float(bs.call), k, df)),
        ("gbm_cliquet", dict(payoff="cliquet", cliquet_reset_every=4, cliquet_floor=0.0,
                             cliquet_cap=0.08, **none),
         arr((s, 0.05, t, r, q, v)), z_both(float(cq.put), float(cq.call), 0.05, df)),
        ("gbm_term", dict(term=term), arr(gbm),
         z_both(float(tb.put), float(tb.call), k, df_term)),
        ("heston", dict(model="heston", timesteps=64, **none), arr(tuple(heston.values())),
         # full-truncation Euler: 0.5% allowance for the discretization bias
         lambda u: (lambda put, call: (
             f"call {_mean_se(call)[0]:.5f} vs {h_call:.5f}, put {_mean_se(put)[0]:.5f} vs "
             f"{h_put:.5f} (4 SE + 0.5%)",
             abs(_mean_se(call)[0] - h_call) < 4 * _mean_se(call)[1] + 0.005 * h_call
             and abs(_mean_se(put)[0] - h_put) < 4 * _mean_se(put)[1] + 0.005 * h_put,
         ))(*_payoffs(u, 100.0, df))),
        ("merton_jump", dict(model="merton_jump", **none), arr(tuple(merton.values())),
         z_both(m_put, m_call, k, df)),
        ("basket_gbm", dict(model="basket_gbm", basket=spec, **none), arr(gbm),
         z_both(float(gb.put), float(gb.call), k, df)),
        ("american_gbm", dict(payoff="american_put", **none), arr(gbm),
         american(bermudan_tree_price(spot=s, strike=k, div_yield=q, vol=v, **tree), k, df)),
        ("american_heston", dict(model="heston", payoff="american_call", timesteps=32,
                                 **none),
         arr(tuple({**heston, "div_yield": 0.0}.values())),
         # a q = 0 call is never exercised early: the European price
         american(heston_call_price(**{**heston, "div_yield": 0.0})[0], k, df)),
        ("american_merton_jump", dict(model="merton_jump", payoff="american_call", **none),
         arr(tuple(merton.values())), american(m_call, k, df)),
        ("american_basket_gbm", dict(model="basket_gbm", basket=spec,
                                     payoff="american_put", **none), arr(gbm),
         american(bermudan_tree_price(spot=float(g0), strike=k, div_yield=float(div_eff),
                                      vol=float(vol_eff), **tree), k, df)),
    ]


def phase_reference(log: Log) -> None:
    """Each engine of each kernel family against its oracle, float32 at the
    smoke width, matmul precision 'highest' (the simulators run no matmul)."""
    from spectralmc_tpu.ops.gbm import (
        SimImplementation,
        build_simulation_params,
        resolve_implementation,
    )

    failures = []
    for name, overrides, contract, check in reference_cases():
        for engine in ("pallas", "xla"):
            sim = build_simulation_params(
                **{**WIDTH, **overrides}, mc_seed=7, implementation=engine
            ).expect(name)
            assert resolve_implementation(sim) == SimImplementation(engine), (name, engine)
            msg, ok = check(simulate(sim, contract))
            log("reference", f"{name:21s} {engine:6s} float32: {msg} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append((name, engine))
    assert not failures, f"reference checks failed: {failures}"


def _time_calls(fn, args, calls: int = 20) -> tuple[float, float]:
    """(compile-and-first-call seconds, median seconds of ``calls`` calls)."""
    import jax

    start = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - start
    times = []
    for _ in range(calls):
        start = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - start)
    return first, statistics.median(times)


def phase_kernels(log: Log, train: dict) -> None:
    """Each kernel against the XLA scan of its family at bench.py's shapes,
    then the train step on both engines."""
    import jax

    from spectralmc_tpu.ops.dispatch import make_underlier_simulator
    from spectralmc_tpu.ops.gbm import build_simulation_params
    from spectralmc_tpu.training.trainer import GbmCVNNPricer

    shapes = {
        "gbm": FLAT_SHAPE, "gbm_cliquet": FLAT_SHAPE, "gbm_term": FLAT_SHAPE,
        "heston": FLAT_SHAPE, "merton_jump": FLAT_SHAPE, "basket_gbm": BASKET_SHAPE,
    }
    for name, overrides, contract, _check in reference_cases():
        shape = shapes.get(name, AMERICAN_SHAPE)
        overrides = {k: v for k, v in overrides.items() if k != "timesteps"}
        if "term" in overrides:
            from spectralmc_tpu.ops.gbm import TermStructure

            n = shape["timesteps"]
            overrides["term"] = TermStructure(
                vol_shape=tuple(1.5 - 1.0 * i / n for i in range(n)),
                rate_shape=tuple(0.5 + 1.0 * i / n for i in range(n)),
            )
        row = {}
        for engine in ("pallas", "xla"):
            sim = build_simulation_params(
                **shape, **overrides, mc_seed=7, implementation=engine
            ).expect(name)
            fn = jax.jit(make_underlier_simulator(sim, rows=sim.batches_per_mc_run))
            row[engine] = _time_calls(fn, (jax.random.PRNGKey(1), contract, 0))
        paths = shape["batches_per_mc_run"] * shape["network_size"]
        log("kernels", f"{name:21s} {paths} paths x {shape['timesteps']} steps: "
            f"pallas {row['pallas'][1] * 1e3:.3f} ms, xla {row['xla'][1] * 1e3:.3f} ms "
            f"(median of 20, xla/pallas {row['xla'][1] / row['pallas'][1]:.2f}x); "
            f"compile+first call pallas {row['pallas'][0]:.1f} s, xla {row['xla'][0]:.1f} s")

    pricer = GbmCVNNPricer.create(baseline3_config("xla")).expect("create xla")
    pricer.train(training(2)).expect("xla warm-up")
    times = []
    for _ in range(3):
        start = time.perf_counter()
        pricer.train(training(2)).expect("xla timed")
        times.append((time.perf_counter() - start) / 2)
    xla_step = statistics.median(times)
    log("kernels", f"train step BASELINE config 3 (512 contracts): pallas "
        f"{train['pallas_step_s'] * 1e3:.2f} ms, xla {xla_step * 1e3:.2f} ms "
        f"(xla/pallas {xla_step / train['pallas_step_s']:.2f}x)")


def phase_four_cards(log: Log) -> None:
    """Sharded training over flat (2, 2) and (4, 1) meshes against a one-card
    run of the same batch, plus one American (LSMC psum) segment. The CVNN
    is config 3's without the covariance BN: BN statistics are per batch
    shard by design (parallel/trainer.py), so only a BN-free model can match
    one card to float32 reduction order."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from spectralmc_tpu.ops.dispatch import make_underlier_simulator
    from spectralmc_tpu.ops.spectrum import local_spectrum_sum
    from spectralmc_tpu.parallel.mesh import build_mesh_spec
    from spectralmc_tpu.training.trainer import GbmCVNNPricer

    devices = jax.devices()
    assert len(devices) == 4, f"--four-cards needs 4 local cards, found {len(devices)}"
    steps = training(2, batch_size=64, chunk=None)
    single = GbmCVNNPricer.create(baseline3_config("pallas", batch_norm=False)).expect(
        "single"
    )
    ref = single.train(steps).expect("single train").losses

    cfg = baseline3_config("pallas")
    sim = cfg.sim
    contracts = jnp.asarray(
        np.random.default_rng(2).uniform([80, 80, 0.25, 0, 0, 0.15], [120, 120, 2, .08, .04, .45],
                                         size=(4, 6)), jnp.float32)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(9), i))(jnp.arange(4))
    rows = sim.batches_per_mc_run

    def spectra(mesh_spec):
        """Batch-mean put spectra of 4 contracts, rows split over 'paths'."""
        n_paths = mesh_spec.paths_divisor
        local = rows // n_paths
        simulate = make_underlier_simulator(sim, rows=local)

        def body(key, contract):
            idx = jax.lax.axis_index(mesh_spec.paths_axis)
            def one(k, c):
                u = simulate(k, c, idx * jnp.uint32(local)).reshape(-1)
                put = jnp.exp(-c[3] * c[2]) * jnp.maximum(c[1] - u, 0.0)
                return local_spectrum_sum(put, batches=local, network_size=sim.network_size)
            return jax.lax.psum(jax.vmap(one)(key, contract), mesh_spec.paths_axis) / rows

        fn = jax.shard_map(
            body, mesh=mesh_spec.mesh,
            in_specs=(P(mesh_spec.batch_axis), P(mesh_spec.batch_axis)),
            out_specs=P(mesh_spec.batch_axis), check_vma=False,
        )
        return np.asarray(jax.jit(fn)(keys, contracts))

    one_card = build_mesh_spec(batch_shards=1, paths_shards=1, devices=devices[:1]).expect("1")
    want = spectra(one_card)
    for shape in ((2, 2), (4, 1)):
        spec = build_mesh_spec(batch_shards=shape[0], paths_shards=shape[1]).expect("mesh")
        sharded = GbmCVNNPricer.create(
            baseline3_config("pallas", batch_norm=False), mesh_spec=spec
        ).expect("sharded")
        got = sharded.train(steps).expect("sharded train").losses
        loss_rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
        spec_got = spectra(spec)
        spec_rel = float(np.max(np.abs(spec_got - want)) / np.max(np.abs(want)))
        log("four-cards", f"mesh (batch={shape[0]}, paths={shape[1]}): losses {got.tolist()} "
            f"vs one card {ref.tolist()}, max rel {loss_rel:.2e}; spectrum max rel "
            f"{spec_rel:.2e} (float32, reduction order)")
        assert loss_rel < 1e-5 and spec_rel < 1e-5, (shape, loss_rel, spec_rel)

    amer = baseline3_config("pallas", payoff="american_put", normalization="none")
    spec = build_mesh_spec(batch_shards=2, paths_shards=2).expect("mesh")
    amer_pricer = GbmCVNNPricer.create(amer, mesh_spec=spec).expect("american sharded")
    losses = amer_pricer.train(training(1, batch_size=64, chunk=None)).expect("amer").losses
    assert np.isfinite(losses).all(), losses
    log("four-cards", f"American put (LSMC moments psum over paths) on (2, 2): "
        f"loss {losses.tolist()} finite")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card sharded phase")
    args = parser.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform}); nothing to test",
              file=sys.stderr)
        return 2
    log = Log(card_name_and_limit())

    from spectralmc_tpu.runtime.jax_runtime import enable_compilation_cache, get_jax_handle

    cache_dir = enable_compilation_cache()
    get_jax_handle()
    phase_device(log, cache_dir)
    if args.four_cards:
        phase_four_cards(log)
    else:
        train = phase_train(log)
        phase_reference(log)
        phase_kernels(log, train)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
