"""Example 8 — multi-host / multi-slice training with ``jax.distributed``
(NEW capability; the reference is single-process by policy, SURVEY §2.9).

Launches itself twice: each worker process joins the distributed runtime
over localhost (a cluster process passes its own coordinator, count and id),
builds the global (slice, batch, paths) mesh, and trains in SPMD with
blockchain commits gated to process 0.

Run hermetically on CPU (2 processes x 4 virtual devices):
  JAX_PLATFORMS=cpu python examples/08_distributed_training.py

On a real pod, run one copy per host with no --worker flags and replace
``num_processes``/``process_id`` with auto-detection
(``initialize_distributed()`` with no arguments).
"""

# Make the repo importable when run straight from a checkout
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def worker(process_id: int, num_processes: int, port: int, store_root: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_platforms", "cpu")

    from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
    from spectralmc_tpu.ops.gbm import build_simulation_params
    from spectralmc_tpu.ops.sobol import BoundSpec
    from spectralmc_tpu.parallel.distributed import (
        build_global_mesh_spec,
        coordinator_only,
        initialize_distributed,
    )
    from spectralmc_tpu.storage.checkpoint import make_commit_fn
    from spectralmc_tpu.storage.object_store import FileSystemObjectStore
    from spectralmc_tpu.storage.store import AsyncBlockchainModelStore
    from spectralmc_tpu.training import (
        FinalCommit,
        GbmCVNNPricer,
        GbmCVNNPricerConfig,
        build_training_config,
    )

    runtime = initialize_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=num_processes,
        process_id=process_id,
    ).expect("distributed init")
    print(
        f"[worker {runtime.process_index}] joined: {runtime.process_count} processes, "
        f"{runtime.global_device_count} global devices"
    )

    bounds = {
        "spot": BoundSpec(lower=80, upper=120),
        "strike": BoundSpec(lower=80, upper=120),
        "maturity": BoundSpec(lower=0.25, upper=1.5),
        "rate": BoundSpec(lower=0.0, upper=0.08),
        "div_yield": BoundSpec(lower=0.0, upper=0.04),
        "vol": BoundSpec(lower=0.15, upper=0.45),
    }
    sim = build_simulation_params(
        timesteps=4, network_size=32, batches_per_mc_run=8, mc_seed=7
    ).expect("sim")
    cvnn = build_cvnn_config(
        layers=[LinearCfg(width=32, activation=Activation.MODRELU)], seed=3
    ).expect("cvnn")
    config = GbmCVNNPricerConfig(
        sim=sim, bounds=bounds, cvnn=cvnn, normalize_inputs=True
    )

    # slice axis = one row per process; contract DP spans ("slice", "batch")
    spec = build_global_mesh_spec(
        num_slices=num_processes, batch_shards_per_slice=2, paths_shards=2
    ).expect("global mesh")
    pricer = GbmCVNNPricer.create(config, mesh_spec=spec).expect("pricer")

    store = AsyncBlockchainModelStore(FileSystemObjectStore(store_root, "models"))
    commit_fn = coordinator_only(make_commit_fn(store), name="commit")
    tc = build_training_config(
        num_batches=8, batch_size=8, learning_rate=2e-3
    ).expect("tc")
    result = pricer.train(tc, commit_plan=FinalCommit(), commit_fn=commit_fn).expect(
        "train"
    )
    print(
        f"[worker {runtime.process_index}] trained {result.total_batches} batches, "
        f"final loss {result.final_loss:.4f}"
        + (" (committed HEAD)" if runtime.is_coordinator else " (commit gated off)")
    )


def main() -> None:
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]), int(sys.argv[i + 3]),
               sys.argv[i + 4])
        return

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    num_processes = 2
    store_root = tempfile.mkdtemp(prefix="spectralmc_dist_")
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--worker", str(i), str(num_processes),
             str(port), store_root]
        )
        for i in range(num_processes)
    ]
    for p in procs:
        p.wait()
    if any(p.returncode for p in procs):
        raise SystemExit("a worker failed")

    # verify exactly one (gated) commit landed
    import asyncio

    from spectralmc_tpu.storage.object_store import FileSystemObjectStore
    from spectralmc_tpu.storage.store import AsyncBlockchainModelStore

    store = AsyncBlockchainModelStore(FileSystemObjectStore(store_root, "models"))
    head = asyncio.run(store.get_head()).expect("head")
    print(f"chain HEAD: {head.version_id} — exactly one commit from process 0")


if __name__ == "__main__":
    main()
