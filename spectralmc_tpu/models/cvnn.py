"""Complex-valued neural-network layers, functional JAX style.

Capability parity with the reference's torch CVNN catalogue
(``/root/reference/src/spectralmc/cvnn.py:65-493``): ComplexLinear, zReLU,
modReLU, naive and covariance (Trabelsi-2018 whitening) complex batch norm,
Sequential and Residual containers.

JAX-first redesign:

* complex values are **split re/im pytrees of real arrays** — the four real
  matmuls of ComplexLinear hit the matrix units directly and optax-on-real-leaves
  reproduces the reference's Wirtinger-correct Adam semantics exactly;
* layers are (init, apply) pairs over immutable pytrees: ``apply`` threads a
  ``state`` pytree for batch-norm running statistics and returns the updated
  state (no in-place buffers);
* covariance BN whitening uses the **closed-form 2×2 inverse square root**
  (trace/det formula) instead of ``torch.linalg.eigh`` (reference
  cvnn.py:411-413) — branch-free VPU math, no eigendecomposition;
* init is keyed threefry, so construction is deterministic on every backend
  (subsumes the reference's CPU-init-under-forked-RNG policy,
  cvnn_factory.py:343-367).

Every layer implements the protocol::

    init(key, in_dim)  -> (params, state, out_dim)
    apply(params, state, re, im, train) -> (re, im, new_state)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Protocol

from jax.typing import DTypeLike

import jax
import jax.numpy as jnp

Params = Any  # nested dict pytree of jnp arrays
State = Any

MODRELU_EPS = 1e-9  # reference cvnn.py:168-210
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class ComplexLayer(Protocol):
    def init(self, key: jax.Array, in_dim: int) -> tuple[Params, State, int]: ...

    def apply(
        self, params: Params, state: State, re: jax.Array, im: jax.Array, train: bool
    ) -> tuple[jax.Array, jax.Array, State]: ...


# --------------------------------------------------------------------------
# ComplexLinear — dense C^n -> C^m as 4 real matmuls (reference cvnn.py:65-143)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ComplexLinear:
    in_dim: int
    out_dim: int
    bias: bool = True
    dtype: DTypeLike = jnp.float32

    def init(self, key: jax.Array, in_dim: int) -> tuple[Params, State, int]:
        assert in_dim == self.in_dim
        k_re, k_im = jax.random.split(key)
        bound = jnp.sqrt(6.0 / (self.in_dim + self.out_dim)).astype(self.dtype)
        shape = (self.in_dim, self.out_dim)
        params = {
            "w_re": jax.random.uniform(k_re, shape, self.dtype, -bound, bound),
            "w_im": jax.random.uniform(k_im, shape, self.dtype, -bound, bound),
        }
        if self.bias:
            params["b_re"] = jnp.zeros((self.out_dim,), self.dtype)
            params["b_im"] = jnp.zeros((self.out_dim,), self.dtype)
        return params, {}, self.out_dim

    def apply(
        self, params: Params, state: State, re: jax.Array, im: jax.Array, train: bool
    ) -> tuple[jax.Array, jax.Array, State]:
        # (A + iB)(x + iy) = (Ax - By) + i(Bx + Ay); A/B stored column-major
        # for x @ W. preferred_element_type pins matmul accumulation precision.
        w_re, w_im = params["w_re"], params["w_im"]
        acc = jnp.promote_types(re.dtype, jnp.float32)
        out_re = jnp.dot(re, w_re, preferred_element_type=acc) - jnp.dot(
            im, w_im, preferred_element_type=acc
        )
        out_im = jnp.dot(re, w_im, preferred_element_type=acc) + jnp.dot(
            im, w_re, preferred_element_type=acc
        )
        if self.bias:
            out_re = out_re + params["b_re"]
            out_im = out_im + params["b_im"]
        return out_re.astype(re.dtype), out_im.astype(im.dtype), state


# --------------------------------------------------------------------------
# Activations (reference cvnn.py:149-210)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ZReLU:
    """First-quadrant gate: pass iff Re >= 0 and Im >= 0 (Guberman 2016)."""

    def init(self, key: jax.Array, in_dim: int) -> tuple[Params, State, int]:
        return {}, {}, in_dim

    def apply(
        self, params: Params, state: State, re: jax.Array, im: jax.Array, train: bool
    ) -> tuple[jax.Array, jax.Array, State]:
        mask = jnp.logical_and(re >= 0, im >= 0).astype(re.dtype)
        return re * mask, im * mask, state


@dataclass(frozen=True)
class ModReLU:
    """Magnitude gate with learned per-feature bias, phase-preserving (Arjovsky 2016)."""

    features: int
    dtype: DTypeLike = jnp.float32

    def init(self, key: jax.Array, in_dim: int) -> tuple[Params, State, int]:
        assert in_dim == self.features
        return {"b": jnp.zeros((self.features,), self.dtype)}, {}, in_dim

    def apply(
        self, params: Params, state: State, re: jax.Array, im: jax.Array, train: bool
    ) -> tuple[jax.Array, jax.Array, State]:
        mag = jnp.sqrt(re * re + im * im)
        scale = jax.nn.relu(mag + params["b"]) / (mag + MODRELU_EPS)
        return re * scale, im * scale, state


# --------------------------------------------------------------------------
# Batch normalization (reference cvnn.py:213-433)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class NaiveComplexBatchNorm:
    """Independent batch norm on Re and Im (reference cvnn.py:213-273)."""

    features: int
    dtype: DTypeLike = jnp.float32
    momentum: float = BN_MOMENTUM
    eps: float = BN_EPS

    def init(self, key: jax.Array, in_dim: int) -> tuple[Params, State, int]:
        assert in_dim == self.features
        f = (self.features,)
        params = {
            "gamma_re": jnp.ones(f, self.dtype),
            "beta_re": jnp.zeros(f, self.dtype),
            "gamma_im": jnp.ones(f, self.dtype),
            "beta_im": jnp.zeros(f, self.dtype),
        }
        state = {
            "mean_re": jnp.zeros(f, self.dtype),
            "var_re": jnp.ones(f, self.dtype),
            "mean_im": jnp.zeros(f, self.dtype),
            "var_im": jnp.ones(f, self.dtype),
        }
        return params, state, in_dim

    def _bn(
        self,
        x: jax.Array,
        gamma: jax.Array,
        beta: jax.Array,
        mean: jax.Array,
        var: jax.Array,
        train: bool,
    ) -> tuple[jax.Array, jax.Array, jax.Array]:
        if train:
            batch_mean = jnp.mean(x, axis=0)
            batch_var = jnp.var(x, axis=0)
            new_mean = (1 - self.momentum) * mean + self.momentum * batch_mean
            # torch tracks unbiased running var
            n = x.shape[0]
            unbiased = batch_var * (n / max(n - 1, 1))
            new_var = (1 - self.momentum) * var + self.momentum * unbiased
            x_hat = (x - batch_mean) * jax.lax.rsqrt(batch_var + self.eps)
            return gamma * x_hat + beta, new_mean, new_var
        x_hat = (x - mean) * jax.lax.rsqrt(var + self.eps)
        return gamma * x_hat + beta, mean, var

    def apply(
        self, params: Params, state: State, re: jax.Array, im: jax.Array, train: bool
    ) -> tuple[jax.Array, jax.Array, State]:
        out_re, m_re, v_re = self._bn(
            re, params["gamma_re"], params["beta_re"], state["mean_re"], state["var_re"], train
        )
        out_im, m_im, v_im = self._bn(
            im, params["gamma_im"], params["beta_im"], state["mean_im"], state["var_im"], train
        )
        return out_re, out_im, {"mean_re": m_re, "var_re": v_re, "mean_im": m_im, "var_im": v_im}


def _inv_sqrt_2x2(
    c_rr: jax.Array, c_ri: jax.Array, c_ii: jax.Array, eps: float
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Closed-form inverse square root of SPD [[c_rr, c_ri], [c_ri, c_ii]].

    With tau = trace, s = sqrt(det), t = sqrt(tau + 2 s):
    M^{-1/2} = [[c_ii + s, -c_ri], [-c_ri, c_rr + s]] / (s t).
    Replaces the reference's batched ``torch.linalg.eigh`` (cvnn.py:411-413,
    SURVEY §2.9 N5) with branch-free elementwise math.
    """
    c_rr = c_rr + eps
    c_ii = c_ii + eps
    det = c_rr * c_ii - c_ri * c_ri
    s = jnp.sqrt(det)
    t = jnp.sqrt(c_rr + c_ii + 2.0 * s)
    denom = 1.0 / (s * t)
    return (c_ii + s) * denom, -c_ri * denom, (c_rr + s) * denom  # w_rr, w_ri, w_ii


@dataclass(frozen=True)
class CovarianceComplexBatchNorm:
    """Trabelsi-2018 whitening batch norm (reference cvnn.py:276-433).

    Centers by the complex mean, whitens by the inverse sqrt of the per-
    feature 2×2 covariance, then applies learnable Γ = [[g_rr, g_ri],
    [g_ri, g_ii]] and complex shift β. Γ init (1/√2, 0, 1/√2) so initial
    output variance is ~1/2 per component, as in the paper and the reference.
    """

    features: int
    dtype: DTypeLike = jnp.float32
    momentum: float = BN_MOMENTUM
    eps: float = BN_EPS

    def init(self, key: jax.Array, in_dim: int) -> tuple[Params, State, int]:
        assert in_dim == self.features
        f = (self.features,)
        inv_sqrt2 = jnp.asarray(1.0 / jnp.sqrt(2.0), self.dtype)
        params = {
            "g_rr": jnp.full(f, inv_sqrt2, self.dtype),
            "g_ri": jnp.zeros(f, self.dtype),
            "g_ii": jnp.full(f, inv_sqrt2, self.dtype),
            "beta_re": jnp.zeros(f, self.dtype),
            "beta_im": jnp.zeros(f, self.dtype),
        }
        state = {
            "mean_re": jnp.zeros(f, self.dtype),
            "mean_im": jnp.zeros(f, self.dtype),
            "c_rr": jnp.full(f, 0.5, self.dtype),
            "c_ri": jnp.zeros(f, self.dtype),
            "c_ii": jnp.full(f, 0.5, self.dtype),
        }
        return params, state, in_dim

    def apply(
        self, params: Params, state: State, re: jax.Array, im: jax.Array, train: bool
    ) -> tuple[jax.Array, jax.Array, State]:
        if train:
            mean_re = jnp.mean(re, axis=0)
            mean_im = jnp.mean(im, axis=0)
            cre = re - mean_re
            cim = im - mean_im
            c_rr = jnp.mean(cre * cre, axis=0)
            c_ri = jnp.mean(cre * cim, axis=0)
            c_ii = jnp.mean(cim * cim, axis=0)
            m = self.momentum
            new_state = {
                "mean_re": (1 - m) * state["mean_re"] + m * mean_re,
                "mean_im": (1 - m) * state["mean_im"] + m * mean_im,
                "c_rr": (1 - m) * state["c_rr"] + m * c_rr,
                "c_ri": (1 - m) * state["c_ri"] + m * c_ri,
                "c_ii": (1 - m) * state["c_ii"] + m * c_ii,
            }
        else:
            mean_re, mean_im = state["mean_re"], state["mean_im"]
            c_rr, c_ri, c_ii = state["c_rr"], state["c_ri"], state["c_ii"]
            cre = re - mean_re
            cim = im - mean_im
            new_state = state
        w_rr, w_ri, w_ii = _inv_sqrt_2x2(c_rr, c_ri, c_ii, self.eps)
        white_re = w_rr * cre + w_ri * cim
        white_im = w_ri * cre + w_ii * cim
        out_re = params["g_rr"] * white_re + params["g_ri"] * white_im + params["beta_re"]
        out_im = params["g_ri"] * white_re + params["g_ii"] * white_im + params["beta_im"]
        return out_re, out_im, new_state


# --------------------------------------------------------------------------
# Containers (reference cvnn.py:439-493)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ComplexSequential:
    layers: tuple[ComplexLayer, ...]

    def init(self, key: jax.Array, in_dim: int) -> tuple[Params, State, int]:
        params: dict[str, Params] = {}
        state: dict[str, State] = {}
        dim = in_dim
        keys = jax.random.split(key, max(len(self.layers), 1))
        for i, layer in enumerate(self.layers):
            p, s, dim = layer.init(keys[i], dim)
            params[f"layer_{i}"] = p
            state[f"layer_{i}"] = s
        return params, state, dim

    def apply(
        self, params: Params, state: State, re: jax.Array, im: jax.Array, train: bool
    ) -> tuple[jax.Array, jax.Array, State]:
        new_state: dict[str, State] = {}
        for i, layer in enumerate(self.layers):
            re, im, s = layer.apply(params[f"layer_{i}"], state[f"layer_{i}"], re, im, train)
            new_state[f"layer_{i}"] = s
        return re, im, new_state


@dataclass(frozen=True)
class ComplexResidual:
    """Residual wrapper with optional projection on width mismatch and
    optional post-activation (reference cvnn.py:454-493)."""

    body: ComplexLayer
    projection: ComplexLayer | None = None
    post_activation: ComplexLayer | None = None

    def init(self, key: jax.Array, in_dim: int) -> tuple[Params, State, int]:
        k_body, k_proj, k_act = jax.random.split(key, 3)
        body_p, body_s, out_dim = self.body.init(k_body, in_dim)
        params: dict[str, Params] = {"body": body_p}
        state: dict[str, State] = {"body": body_s}
        if self.projection is not None:
            proj_p, proj_s, proj_dim = self.projection.init(k_proj, in_dim)
            assert proj_dim == out_dim, "projection must map input width to body output width"
            params["projection"] = proj_p
            state["projection"] = proj_s
        else:
            assert out_dim == in_dim, "residual without projection requires matching widths"
        if self.post_activation is not None:
            act_p, act_s, _ = self.post_activation.init(k_act, out_dim)
            params["post_activation"] = act_p
            state["post_activation"] = act_s
        return params, state, out_dim

    def apply(
        self, params: Params, state: State, re: jax.Array, im: jax.Array, train: bool
    ) -> tuple[jax.Array, jax.Array, State]:
        out_re, out_im, body_s = self.body.apply(params["body"], state["body"], re, im, train)
        new_state: dict[str, State] = {"body": body_s}
        if self.projection is not None:
            skip_re, skip_im, proj_s = self.projection.apply(
                params["projection"], state["projection"], re, im, train
            )
            new_state["projection"] = proj_s
        else:
            skip_re, skip_im = re, im
        out_re = out_re + skip_re
        out_im = out_im + skip_im
        if self.post_activation is not None:
            out_re, out_im, act_s = self.post_activation.apply(
                params["post_activation"], state["post_activation"], out_re, out_im, train
            )
            new_state["post_activation"] = act_s
        return out_re, out_im, new_state
