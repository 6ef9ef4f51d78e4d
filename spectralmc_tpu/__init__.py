"""spectralmc_tpu — a JAX-native spectral Monte-Carlo learning framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of SpectralMC
(reference: Tuee22/SpectralMC): complex-valued neural networks trained online
on the DFT (characteristic function) of Monte-Carlo sample distributions,
with deterministic snapshot/resume, content-addressed blockchain model
versioning, and production inference serving.

JAX-first design:
* one jitted program per train step (Sobol → GBM paths → FFT → CVNN fwd/bwd →
  Adam) with zero host transfers;
* stateless threefry RNG keys replace the reference's stream pools and
  RNG-byte-blob checkpoints;
* MC paths shard across a ``jax.sharding.Mesh`` with psum-reduced spectra;
* a fused Pallas kernel covers the RNG+path-stepping hot loop.
"""

__version__ = "0.1.0"

# Lazy top-level API (PEP 562): the names a user reaches for first, without
# paying jax-import cost for `import spectralmc_tpu` alone.
_EXPORTS = {
    "Result": "spectralmc_tpu.core.result",
    "Success": "spectralmc_tpu.core.result",
    "Failure": "spectralmc_tpu.core.result",
    "Precision": "spectralmc_tpu.core.precision",
    "BlackScholes": "spectralmc_tpu.ops.gbm",
    "BlackScholesContract": "spectralmc_tpu.ops.gbm",
    "SimulationParams": "spectralmc_tpu.ops.gbm",
    "build_simulation_params": "spectralmc_tpu.ops.gbm",
    "PathScheme": "spectralmc_tpu.ops.gbm",
    "PayoffKind": "spectralmc_tpu.ops.gbm",
    "ModelKind": "spectralmc_tpu.ops.gbm",
    "SimImplementation": "spectralmc_tpu.ops.gbm",
    "SamplingKind": "spectralmc_tpu.ops.gbm",
    "TermStructure": "spectralmc_tpu.ops.gbm",
    "bootstrap_vol_shape": "spectralmc_tpu.ops.gbm",
    "term_effective_black": "spectralmc_tpu.ops.analytic",
    "HestonContract": "spectralmc_tpu.ops.heston",
    "MertonContract": "spectralmc_tpu.ops.merton",
    "merton_call_price": "spectralmc_tpu.ops.merton",
    "BasketSpec": "spectralmc_tpu.ops.basket",
    "build_basket_spec": "spectralmc_tpu.ops.basket",
    "BasketCombine": "spectralmc_tpu.ops.basket",
    "lsmc_price": "spectralmc_tpu.ops.american",
    "bermudan_tree_price": "spectralmc_tpu.ops.american",
    "mc_greeks": "spectralmc_tpu.ops.greeks",
    "analytic_greeks": "spectralmc_tpu.ops.greeks",
    "OptionSide": "spectralmc_tpu.ops.greeks",
    "BoundSpec": "spectralmc_tpu.ops.sobol",
    "SobolSampler": "spectralmc_tpu.ops.sobol",
    "build_cvnn_config": "spectralmc_tpu.models.factory",
    "build_model": "spectralmc_tpu.models.factory",
    "Activation": "spectralmc_tpu.models.factory",
    "LinearCfg": "spectralmc_tpu.models.factory",
    "GbmCVNNPricer": "spectralmc_tpu.training.trainer",
    "GbmCVNNPricerConfig": "spectralmc_tpu.training.trainer",
    "build_training_config": "spectralmc_tpu.training.trainer",
    "NoCommit": "spectralmc_tpu.training.trainer",
    "FinalCommit": "spectralmc_tpu.training.trainer",
    "IntervalCommit": "spectralmc_tpu.training.trainer",
    "FinalAndIntervalCommit": "spectralmc_tpu.training.trainer",
    "AsyncBlockchainModelStore": "spectralmc_tpu.storage.store",
    "FileSystemObjectStore": "spectralmc_tpu.storage.object_store",
    "InferenceClient": "spectralmc_tpu.storage.inference",
}

__all__ = ["__version__", *sorted(_EXPORTS)]


def __dir__() -> list[str]:
    return sorted(__all__)


def __getattr__(name: str) -> object:
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)
