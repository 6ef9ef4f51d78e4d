#!/usr/bin/env python
"""Exhaustive model check: snapshot/restore ≡ continuous training.

The reference ships a TLA+ *workflow* asserting this property but commits no
spec — TLC is run against a doctrine-described training state machine
(``/root/reference/tools/run_tla.py``, ``documents/engineering/tla.md:32-50``).
This tool goes further: it checks the property against the **real
implementation**, exhaustively.

Property. For a training run of N batches, every composition of N into
ordered positive segments — with a full snapshot → protobuf serialize →
deserialize → restore cycle between segments — must produce a final state
(weights, BN state, Adam moments, global_step, sobol/MC draw counters)
bit-identical to the single continuous N-batch run. There are 2^(N-1)
compositions; N=6 checks 32 schedules.

This is the determinism contract the whole storage/versioning layer rests
on (SURVEY §5 checkpoint/resume: "resume ≡ continuous training, bit-exact").

    JAX_PLATFORMS=cpu python tools/model_check.py [--batches 6] [--verbose]
"""

from __future__ import annotations

import argparse
import itertools
import sys
from pathlib import Path
from typing import Iterator

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _pin_cpu() -> None:
    """Force the CPU backend even where an accelerator plugin overrides JAX_PLATFORMS."""
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:  # backend already initialized by the caller
        pass


def compositions(n: int) -> Iterator[tuple[int, ...]]:
    """All ordered compositions of n into positive parts (2^(n-1) of them)."""
    for cuts in itertools.product((False, True), repeat=n - 1):
        parts: list[int] = []
        size = 1
        for cut in cuts:
            if cut:
                parts.append(size)
                size = 1
            else:
                size += 1
        parts.append(size)
        yield tuple(parts)


def _final_state(snapshot) -> dict:
    import numpy as np

    return {
        "global_step": snapshot.global_step,
        "sobol_skip": snapshot.sobol_skip,
        "mc_skip": snapshot.sim.skip,
        "model": {k: np.asarray(v) for k, v in (snapshot.model_state or {}).items()},
        "opt": _opt_tensors(snapshot.optimizer_state),
    }


def _opt_tensors(opt) -> dict:
    """Typed AdamStateSnapshot -> comparable flat tensor dict."""
    import numpy as np

    if opt is None:
        return {}
    out = {"count": np.asarray(opt.count)}
    for k, v in opt.mu.items():
        out[f"mu/{k}"] = np.asarray(v)
    for k, v in opt.nu.items():
        out[f"nu/{k}"] = np.asarray(v)
    return out


def _diff(a: dict, b: dict) -> list[str]:
    import numpy as np

    out = []
    for field in ("global_step", "sobol_skip", "mc_skip"):
        if a[field] != b[field]:
            out.append(f"{field}: {a[field]} != {b[field]}")
    for group in ("model", "opt"):
        keys_a, keys_b = set(a[group]), set(b[group])
        for k in keys_a ^ keys_b:
            out.append(f"{group}[{k}]: present in one side only")
        for k in keys_a & keys_b:
            if not np.array_equal(a[group][k], b[group][k]):
                delta = float(np.max(np.abs(a[group][k] - b[group][k])))
                out.append(f"{group}[{k}]: max|Δ|={delta:g}")
    return out


def run_model_check(total_batches: int = 6, *, verbose: bool = False) -> int:
    """Returns the number of schedules that violated the property."""
    _pin_cpu()
    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
    from spectralmc_tpu.ops.gbm import build_simulation_params
    from spectralmc_tpu.ops.sobol import BoundSpec
    from spectralmc_tpu.serialization.converters import (
        deserialize_checkpoint,
        serialize_checkpoint,
    )
    from spectralmc_tpu.training.trainer import (
        GbmCVNNPricer,
        GbmCVNNPricerConfig,
        build_training_config,
    )

    bounds = {
        "spot": BoundSpec(lower=90.0, upper=110.0),
        "strike": BoundSpec(lower=90.0, upper=110.0),
        "maturity": BoundSpec(lower=0.5, upper=1.5),
        "rate": BoundSpec(lower=0.0, upper=0.05),
        "div_yield": BoundSpec(lower=0.0, upper=0.02),
        "vol": BoundSpec(lower=0.1, upper=0.4),
    }
    sim = build_simulation_params(
        mc_seed=17, timesteps=2, network_size=8, batches_per_mc_run=8
    ).expect("sim")
    cvnn = build_cvnn_config(
        layers=[LinearCfg(width=8, activation=Activation.MODRELU)], seed=23
    ).expect("cvnn")
    base = GbmCVNNPricerConfig(sim=sim, bounds=bounds, cvnn=cvnn)

    def train_schedule(parts: tuple[int, ...]) -> dict:
        config = base
        for part in parts:
            pricer = GbmCVNNPricer.create(config).expect("create")
            cfg = build_training_config(
                num_batches=part, batch_size=4, learning_rate=1e-3
            ).expect("cfg")
            pricer.train(cfg).expect("train")
            # full persistence cycle between segments: snapshot -> proto
            # bytes -> parse -> restored config (what a blockchain commit +
            # inference reload does)
            blob, digest = serialize_checkpoint(pricer.snapshot())
            config = deserialize_checkpoint(blob, expected_hash=digest).expect("deserialize")
        return _final_state(config)

    reference = train_schedule((total_batches,))
    failures = 0
    schedules = [p for p in compositions(total_batches) if p != (total_batches,)]
    for parts in schedules:
        state = train_schedule(parts)
        diffs = _diff(reference, state)
        status = "FAIL" if diffs else "ok"
        if diffs:
            failures += 1
        if verbose or diffs:
            print(f"schedule {parts}: {status}")
            for d in diffs:
                print(f"    {d}")
    print(
        f"model-check: {len(schedules)} schedules x {total_batches} batches, "
        f"{failures} violation(s) — snapshot/restore "
        f"{'≢' if failures else '≡'} continuous training"
    )
    return failures


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, default=6)
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    return 1 if run_model_check(args.batches, verbose=args.verbose) else 0


if __name__ == "__main__":
    raise SystemExit(main())
