"""Declarative CVNN config → model compiler.

Capability parity with ``/root/reference/src/spectralmc/cvnn_factory.py``
(:56-431): a recursive layer-config ADT (linear / naive-BN / covariance-BN /
sequential / residual, with width threading and automatic projection
insertion on width mismatch), a frozen ``CVNNConfig`` that doubles as the
checkpoint's architecture record, deterministic seeded construction, and
state-dict round-tripping.

JAX-first: ``build_model`` compiles the config to a pure ``(init, apply)``
pair over split re/im pytrees; init uses threefry keys derived from
``cfg.seed`` so construction is bit-deterministic on every backend (the
reference needed CPU-init-under-forked-RNG to get this, cvnn_factory.py:343-367).
"""

from __future__ import annotations

import enum
from typing import Annotated, Literal, Mapping, Union

from jax.typing import DTypeLike

from spectralmc_tpu.core.aliases import PyTree

import jax
import jax.numpy as jnp
import numpy as np
from pydantic import BaseModel, ConfigDict, Field

from spectralmc_tpu.core.errors.cvnn import (
    CVNNError,
    InvalidLayerConfig,
    InvalidModelConfig,
    StateDictMismatch,
)
from spectralmc_tpu.core.precision import Precision
from spectralmc_tpu.core.result import Failure, Result, Success
from spectralmc_tpu.models.cvnn import (
    ComplexLayer,
    ComplexLinear,
    ComplexResidual,
    ComplexSequential,
    CovarianceComplexBatchNorm,
    ModReLU,
    NaiveComplexBatchNorm,
    Params,
    State,
    ZReLU,
)


class Activation(enum.Enum):
    NONE = "none"
    ZRELU = "zrelu"
    MODRELU = "modrelu"


class LinearCfg(BaseModel):
    """Dense layer; ``width=None`` preserves the incoming width (reference WidthSpec.Preserve)."""

    model_config = ConfigDict(frozen=True, extra="forbid")
    kind: Literal["linear"] = "linear"
    width: int | None = None
    bias: bool = True
    activation: Activation = Activation.NONE


class NaiveBNCfg(BaseModel):
    model_config = ConfigDict(frozen=True, extra="forbid")
    kind: Literal["naive_bn"] = "naive_bn"


class CovBNCfg(BaseModel):
    model_config = ConfigDict(frozen=True, extra="forbid")
    kind: Literal["cov_bn"] = "cov_bn"


class SequentialCfg(BaseModel):
    model_config = ConfigDict(frozen=True, extra="forbid")
    kind: Literal["sequential"] = "sequential"
    layers: tuple["LayerCfg", ...]


class ResidualCfg(BaseModel):
    """Residual block; a projection is auto-inserted when the body changes width."""

    model_config = ConfigDict(frozen=True, extra="forbid")
    kind: Literal["residual"] = "residual"
    body: "LayerCfg"
    activation: Activation = Activation.NONE


LayerCfg = Annotated[
    Union[LinearCfg, NaiveBNCfg, CovBNCfg, SequentialCfg, ResidualCfg],
    Field(discriminator="kind"),
]

SequentialCfg.model_rebuild()
ResidualCfg.model_rebuild()


class CVNNConfig(BaseModel):
    """Architecture record; serialized into checkpoints (reference CVNNConfig)."""

    model_config = ConfigDict(frozen=True, extra="forbid")
    precision: Precision = Precision.float32
    layers: tuple[LayerCfg, ...]
    seed: int
    final_activation: Activation = Activation.NONE


def build_cvnn_config(
    *,
    layers: tuple[LayerCfg, ...] | list[LayerCfg],
    seed: int,
    precision: Precision = Precision.float32,
    final_activation: Activation = Activation.NONE,
) -> Result[CVNNConfig, CVNNError]:
    if seed < 0:
        return Failure(InvalidModelConfig(field="seed", reason="seed must be >= 0"))
    if precision.is_complex():
        return Failure(
            InvalidModelConfig(
                field="precision", reason="config precision is the real backing dtype"
            )
        )
    checked = precision.validate_available()
    if isinstance(checked, Failure):
        return Failure(InvalidModelConfig(field="precision", reason=checked.error.reason))
    return Success(
        CVNNConfig(
            precision=precision,
            layers=tuple(layers),
            seed=seed,
            final_activation=final_activation,
        )
    )


# --------------------------------------------------------------------------
# Compilation: config → layer tree
# --------------------------------------------------------------------------


def _activation_layer(act: Activation, width: int, dtype: DTypeLike) -> ComplexLayer | None:
    if act == Activation.NONE:
        return None
    if act == Activation.ZRELU:
        return ZReLU()
    return ModReLU(features=width, dtype=dtype)


def _compile_layer(
    cfg: LayerCfg, in_dim: int, dtype: DTypeLike, index: int
) -> Result[tuple[ComplexLayer, int], CVNNError]:
    """Compile one config node; returns (layer, out_dim)."""
    if isinstance(cfg, LinearCfg):
        out_dim = cfg.width if cfg.width is not None else in_dim
        if out_dim <= 0:
            return Failure(
                InvalidLayerConfig(layer_index=index, kind="linear", reason="width must be > 0")
            )
        parts: list[ComplexLayer] = [
            ComplexLinear(in_dim=in_dim, out_dim=out_dim, bias=cfg.bias, dtype=dtype)
        ]
        act = _activation_layer(cfg.activation, out_dim, dtype)
        if act is not None:
            parts.append(act)
        layer = parts[0] if len(parts) == 1 else ComplexSequential(tuple(parts))
        return Success((layer, out_dim))
    if isinstance(cfg, NaiveBNCfg):
        return Success((NaiveComplexBatchNorm(features=in_dim, dtype=dtype), in_dim))
    if isinstance(cfg, CovBNCfg):
        return Success((CovarianceComplexBatchNorm(features=in_dim, dtype=dtype), in_dim))
    if isinstance(cfg, SequentialCfg):
        compiled: list[ComplexLayer] = []
        dim = in_dim
        for i, sub in enumerate(cfg.layers):
            res = _compile_layer(sub, dim, dtype, index * 1000 + i)
            if isinstance(res, Failure):
                return Failure(res.error)
            layer, dim = res.value
            compiled.append(layer)
        return Success((ComplexSequential(tuple(compiled)), dim))
    if isinstance(cfg, ResidualCfg):
        body_res = _compile_layer(cfg.body, in_dim, dtype, index * 1000)
        if isinstance(body_res, Failure):
            return Failure(body_res.error)
        body, out_dim = body_res.value
        # Auto projection on width mismatch (reference cvnn_factory width threading)
        projection = (
            ComplexLinear(in_dim=in_dim, out_dim=out_dim, bias=False, dtype=dtype)
            if out_dim != in_dim
            else None
        )
        post = _activation_layer(cfg.activation, out_dim, dtype)
        return Success((ComplexResidual(body=body, projection=projection, post_activation=post), out_dim))
    return Failure(
        InvalidLayerConfig(layer_index=index, kind=type(cfg).__name__, reason="unknown layer kind")
    )


class CVNN:
    """A compiled complex-valued model: deterministic init + pure apply."""

    def __init__(
        self, config: CVNNConfig, tree: ComplexLayer, input_dim: int, output_dim: int
    ) -> None:
        self.config = config
        self._tree = tree
        self.input_dim = input_dim
        self.output_dim = output_dim

    def init(self) -> tuple[Params, State]:
        """Seeded parameter/state construction — bit-deterministic per backend."""
        key = jax.random.PRNGKey(self.config.seed)
        params, state, out = self._tree.init(key, self.input_dim)
        assert out == self.output_dim
        return params, state

    def apply(
        self, params: Params, state: State, re: jax.Array, im: jax.Array, *, train: bool
    ) -> tuple[jax.Array, jax.Array, State]:
        return self._tree.apply(params, state, re, im, train)

    def __call__(
        self, params: Params, state: State, re: jax.Array, im: jax.Array, *, train: bool = False
    ) -> tuple[jax.Array, jax.Array, State]:
        return self.apply(params, state, re, im, train=train)


def build_model(
    config: CVNNConfig, *, input_dim: int, output_dim: int
) -> Result[CVNN, CVNNError]:
    """Compile config → model, threading widths and appending the output head.

    Mirrors the reference ``build_model`` (cvnn_factory.py:343-367): widths
    are threaded through a fold, a final output projection to ``output_dim``
    is appended, then the final activation.
    """
    if input_dim <= 0 or output_dim <= 0:
        return Failure(InvalidModelConfig(field="input/output_dim", reason="must be positive"))
    dtype = config.precision.to_jnp()
    compiled: list[ComplexLayer] = []
    dim = input_dim
    for i, layer_cfg in enumerate(config.layers):
        res = _compile_layer(layer_cfg, dim, dtype, i)
        if isinstance(res, Failure):
            return Failure(res.error)
        layer, dim = res.value
        compiled.append(layer)
    compiled.append(ComplexLinear(in_dim=dim, out_dim=output_dim, bias=True, dtype=dtype))
    final_act = _activation_layer(config.final_activation, output_dim, dtype)
    if final_act is not None:
        compiled.append(final_act)
    return Success(CVNN(config, ComplexSequential(tuple(compiled)), input_dim, output_dim))


# --------------------------------------------------------------------------
# State-dict round-trip (reference load_model/get_safetensors, :382-431)
# --------------------------------------------------------------------------


def get_state_dict(params: Params, state: State) -> dict[str, np.ndarray]:
    """Flatten (params, state) to host numpy arrays keyed by tree path."""
    out: dict[str, np.ndarray] = {}
    for prefix, tree in (("params", params), ("state", state)):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        for path, leaf in flat:
            key = prefix + "".join(
                f"/{p.key}" if hasattr(p, "key") else f"/{p.idx}" for p in path
            )
            out[key] = np.asarray(leaf)
    return out


def load_state_dict(
    model: CVNN, flat: Mapping[str, np.ndarray]
) -> Result[tuple[Params, State], CVNNError]:
    """Rebuild (params, state) pytrees from a flat dict, checking shape/dtype."""
    template_params, template_state = model.init()
    template_flat = get_state_dict(template_params, template_state)
    if set(template_flat.keys()) != set(flat.keys()):
        missing = set(template_flat) - set(flat)
        extra = set(flat) - set(template_flat)
        return Failure(
            StateDictMismatch(
                key=next(iter(missing | extra)),
                reason=f"missing={sorted(missing)} extra={sorted(extra)}",
            )
        )
    for key, template_leaf in template_flat.items():
        got = flat[key]
        if tuple(got.shape) != tuple(template_leaf.shape):
            return Failure(
                StateDictMismatch(
                    key=key, reason=f"shape {got.shape} != expected {template_leaf.shape}"
                )
            )
        if np.dtype(got.dtype) != np.dtype(template_leaf.dtype):
            return Failure(
                StateDictMismatch(
                    key=key, reason=f"dtype {got.dtype} != expected {template_leaf.dtype}"
                )
            )

    def rebuild(prefix: str, tree: PyTree) -> PyTree:
        leaves_with_path = jax.tree_util.tree_flatten_with_path(tree)
        paths = [
            prefix + "".join(f"/{p.key}" if hasattr(p, "key") else f"/{p.idx}" for p in path)
            for path, _ in leaves_with_path[0]
        ]
        new_leaves = [jnp.asarray(flat[k]) for k in paths]
        return jax.tree_util.tree_unflatten(leaves_with_path[1], new_leaves)

    return Success((rebuild("params", template_params), rebuild("state", template_state)))
