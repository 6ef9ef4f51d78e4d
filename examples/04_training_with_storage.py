"""Example 4 — training with interval blockchain commits + reload.

Parity: reference examples/training_with_storage + checkpoint_training.
Run: JAX_PLATFORMS=cpu python examples/04_training_with_storage.py
"""

# Make the repo importable when run straight from a checkout
import sys
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# Honor JAX_PLATFORMS even where an accelerator plugin overrides the env var
import os
if os.environ.get("JAX_PLATFORMS"):
    import jax
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import asyncio
import tempfile

import numpy as np

from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
from spectralmc_tpu.ops.gbm import build_simulation_params
from spectralmc_tpu.ops.sobol import BoundSpec
from spectralmc_tpu.storage import AsyncBlockchainModelStore, FileSystemObjectStore
from spectralmc_tpu.storage.checkpoint import load_snapshot_from_checkpoint, make_commit_fn
from spectralmc_tpu.training import (
    FinalAndIntervalCommit,
    GbmCVNNPricer,
    GbmCVNNPricerConfig,
    build_training_config,
)

BOUNDS = {
    "spot": BoundSpec(lower=80, upper=120),
    "strike": BoundSpec(lower=80, upper=120),
    "maturity": BoundSpec(lower=0.25, upper=1.5),
    "rate": BoundSpec(lower=0.0, upper=0.08),
    "div_yield": BoundSpec(lower=0.0, upper=0.04),
    "vol": BoundSpec(lower=0.15, upper=0.45),
}


def make_config() -> GbmCVNNPricerConfig:
    sim = build_simulation_params(
        timesteps=4, network_size=32, batches_per_mc_run=8, mc_seed=42
    ).expect("sim")
    cvnn = build_cvnn_config(
        layers=[LinearCfg(width=32, activation=Activation.MODRELU)], seed=1
    ).expect("cvnn")
    return GbmCVNNPricerConfig(sim=sim, bounds=BOUNDS, cvnn=cvnn)


with tempfile.TemporaryDirectory() as root:
    store = AsyncBlockchainModelStore(FileSystemObjectStore(root, "training"))
    pricer = GbmCVNNPricer.create(make_config()).expect("pricer")
    result = pricer.train(
        build_training_config(num_batches=8, batch_size=8, learning_rate=2e-3).expect("cfg"),
        commit_plan=FinalAndIntervalCommit(interval=3),
        commit_fn=make_commit_fn(store),
    ).expect("training")
    print(f"trained {result.total_batches} batches, final loss {result.final_loss:.3f}")

    versions = asyncio.run(store.list_versions()).expect("list")
    for v in versions:
        print(f"  {v.version_id}: {v.message}")

    # reload HEAD and continue — identical to continuous training
    head = asyncio.run(store.get_head()).expect("head")
    restored_cfg = asyncio.run(load_snapshot_from_checkpoint(store, head)).expect("load")
    restored = GbmCVNNPricer.create(restored_cfg).expect("restored")
    r1 = pricer.train(
        build_training_config(num_batches=2, batch_size=8, learning_rate=2e-3).expect("cfg")
    ).expect("t")
    r2 = restored.train(
        build_training_config(num_batches=2, batch_size=8, learning_rate=2e-3).expect("cfg")
    ).expect("t")
    print("resume == continuous:", bool(np.array_equal(r1.losses, r2.losses)))
