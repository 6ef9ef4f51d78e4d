"""Example 6 — multi-chip sharded training on a device mesh (NEW capability;
the reference is single-GPU by policy, SURVEY §2.9).

Run on 8 virtual devices:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/06_sharded_training.py
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

import numpy as np

import jax

from spectralmc_tpu.models.factory import Activation, LinearCfg, build_cvnn_config
from spectralmc_tpu.ops.gbm import build_simulation_params
from spectralmc_tpu.ops.sobol import BoundSpec
from spectralmc_tpu.parallel import build_mesh_spec
from spectralmc_tpu.training import GbmCVNNPricer, GbmCVNNPricerConfig, build_training_config

BOUNDS = {
    "spot": BoundSpec(lower=80, upper=120),
    "strike": BoundSpec(lower=80, upper=120),
    "maturity": BoundSpec(lower=0.25, upper=1.5),
    "rate": BoundSpec(lower=0.0, upper=0.08),
    "div_yield": BoundSpec(lower=0.0, upper=0.04),
    "vol": BoundSpec(lower=0.15, upper=0.45),
}

n = len(jax.devices())
print(f"devices: {n} x {jax.devices()[0].platform}")

sim = build_simulation_params(
    timesteps=4, network_size=32, batches_per_mc_run=8, mc_seed=42
).expect("sim")
cvnn = build_cvnn_config(
    layers=[LinearCfg(width=32, activation=Activation.MODRELU)], seed=1
).expect("cvnn")
config = GbmCVNNPricerConfig(sim=sim, bounds=BOUNDS, cvnn=cvnn)
training = build_training_config(num_batches=6, batch_size=16, learning_rate=2e-3).expect("c")

single = GbmCVNNPricer.create(config).expect("single")
r_single = single.train(training).expect("t")

if n >= 8:
    # contracts sharded 4-way, MC batch rows sharded 2-way
    spec = build_mesh_spec(batch_shards=4, paths_shards=2).expect("mesh")
    sharded = GbmCVNNPricer.create(config, mesh_spec=spec).expect("sharded")
    r_sharded = sharded.train(training).expect("t")
    rel = np.max(np.abs(r_sharded.losses - r_single.losses) / np.abs(r_single.losses))
    print(f"sharded (4x2 mesh) vs single-device: max relative loss diff = {rel:.2e}")
else:
    print("need 8 devices for the sharded run; set XLA_FLAGS as in the docstring")
