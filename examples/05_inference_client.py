"""Example 5 — pinned and tracking inference clients with hot swap.

Parity: reference examples/pinned_inference + tracking_inference.
Run: JAX_PLATFORMS=cpu python examples/05_inference_client.py
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

from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
from spectralmc_tpu.ops.gbm import BlackScholesContract, build_simulation_params
from spectralmc_tpu.ops.sobol import BoundSpec
from spectralmc_tpu.storage import (
    AsyncBlockchainModelStore,
    FileSystemObjectStore,
    InferenceClient,
    PinnedMode,
    TrackingMode,
)
from spectralmc_tpu.storage.checkpoint import commit_snapshot
from spectralmc_tpu.training import GbmCVNNPricer, GbmCVNNPricerConfig, build_training_config

BOUNDS = {
    "spot": BoundSpec(lower=80, upper=120),
    "strike": BoundSpec(lower=80, upper=120),
    "maturity": BoundSpec(lower=0.25, upper=1.5),
    "rate": BoundSpec(lower=0.0, upper=0.08),
    "div_yield": BoundSpec(lower=0.0, upper=0.04),
    "vol": BoundSpec(lower=0.15, upper=0.45),
}


def make_pricer() -> GbmCVNNPricer:
    sim = build_simulation_params(
        timesteps=2, network_size=16, batches_per_mc_run=4, mc_seed=42
    ).expect("sim")
    cvnn = build_cvnn_config(
        layers=[LinearCfg(width=16, activation=Activation.MODRELU)], seed=1
    ).expect("cvnn")
    return GbmCVNNPricer.create(
        GbmCVNNPricerConfig(sim=sim, bounds=BOUNDS, cvnn=cvnn)
    ).expect("pricer")


async def main() -> None:
    with tempfile.TemporaryDirectory() as root:
        store = AsyncBlockchainModelStore(FileSystemObjectStore(root, "serving"))

        # train + commit v0
        pricer = make_pricer()
        pricer.train(
            build_training_config(num_batches=2, batch_size=4, learning_rate=1e-3).expect("c")
        ).expect("t")
        (await commit_snapshot(store, pricer.snapshot(), "v0")).expect("commit")

        # pinned client serves exactly v0 forever
        async with InferenceClient(store, PinnedMode(counter=0)) as pinned:
            loaded = pinned.get_model()
            print(f"pinned: serving {loaded.version.version_id} "
                  f"(global_step={loaded.config.global_step})")

        # tracking client hot-swaps when a new version lands
        tracker = InferenceClient(store, TrackingMode(), poll_interval=0.05)
        (await tracker.start()).expect("start")
        print(f"tracking: started on {tracker.get_model().version.version_id}")

        pricer.train(
            build_training_config(num_batches=2, batch_size=4, learning_rate=1e-3).expect("c")
        ).expect("t")
        (await commit_snapshot(store, pricer.snapshot(), "v1")).expect("commit")
        for _ in range(100):
            await asyncio.sleep(0.05)
            if tracker.get_model().version.counter == 1:
                break
        print(f"tracking: hot-swapped to {tracker.get_model().version.version_id}")
        await tracker.stop()

        # serve a prediction from the tracked snapshot
        serving = GbmCVNNPricer.create(tracker.get_model().config).expect("serve")
        pred = serving.predict_price(
            [BlackScholesContract(spot=100, strike=100, maturity=1.0,
                                  rate=0.03, div_yield=0.01, vol=0.25)]
        )
        print(f"served put price: {float(pred.put[0]):.4f}")

        # hot path for a fleet that already holds contracts columnar: a
        # [N, 6] numpy array (model_fields order) skips Python marshalling
        # and is bit-identical to the instance path (round 5; each call is
        # one host->device put + one packed fetch)
        import numpy as np

        arr = np.array([[100.0, 100.0, 1.0, 0.03, 0.01, 0.25]], np.float32)
        fast = serving.predict_price(arr)
        assert float(fast.put[0]) == float(pred.put[0])
        print(f"columnar fast path: {float(fast.put[0]):.4f} (bit-equal)")


asyncio.run(main())
