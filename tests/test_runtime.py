"""Runtime facade tests (parity: reference test_models_cpu_gpu_transfer etc.)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from spectralmc_tpu.core.result import Failure, Success
from spectralmc_tpu.runtime import (
    DirectTransfer,
    HostPlacement,
    JaxRuntime,
    RejectTransfer,
    StayOnPlacement,
    apply_jax_runtime,
    decide_jax_runtime,
    get_jax_handle,
    get_tree_placement,
    move_tensor_tree,
    plan_tensor_transfer,
)
from spectralmc_tpu.runtime.transfer import DevicePlacement


def test_decide_and_apply_runtime_idempotent() -> None:
    runtime = decide_jax_runtime()
    assert runtime.backend == "cpu"  # test harness pins cpu
    assert runtime.device_count == 8
    assert runtime.x64_enabled
    first = apply_jax_runtime(runtime)
    second = apply_jax_runtime(decide_jax_runtime(matmul_precision="default"))
    assert first is second  # applied exactly once, later applies are no-ops
    assert get_jax_handle() is first
    assert jax.config.jax_default_matmul_precision == "highest"


def test_tree_placement_uniformity() -> None:
    tree = {"a": jnp.ones(4, jnp.float32), "b": [jnp.zeros((2, 2), jnp.float32)]}
    placement, dtype = (
        get_tree_placement(tree).value  # type: ignore[union-attr]
    )
    assert isinstance(placement, HostPlacement)  # cpu backend counts as host
    assert dtype == "float32"
    mixed = {"a": jnp.ones(4, jnp.float32), "b": jnp.ones(4, jnp.float64)}
    assert isinstance(get_tree_placement(mixed), Failure)
    assert isinstance(get_tree_placement({}), Failure)


def test_plan_decisions() -> None:
    tree = {"w": jnp.ones((8, 8), jnp.float32)}
    stay = plan_tensor_transfer(tree, HostPlacement())
    assert isinstance(stay, StayOnPlacement)
    move = plan_tensor_transfer(tree, DevicePlacement(device_kind="gpu"))
    assert isinstance(move, DirectTransfer)
    assert move.total_bytes == 8 * 8 * 4
    big = {"w": np.ones((1024, 1024, 3), np.float64)}  # 24 MiB, cap it at 1 MiB
    reject = plan_tensor_transfer(big, HostPlacement(), host_cap_bytes=1 << 20)
    # numpy tree is already host -> Stay wins over cap
    assert isinstance(reject, StayOnPlacement)


def test_move_tensor_tree_host_roundtrip() -> None:
    # On the cpu test backend a jnp array is already host placement -> Stay.
    tree = {"w": jnp.arange(6).reshape(2, 3)}
    moved = move_tensor_tree(tree, HostPlacement())
    assert isinstance(moved, Success)
    np.testing.assert_array_equal(np.asarray(moved.value["w"]), np.arange(6).reshape(2, 3))
    # numpy tree moving to a nonexistent accelerator -> explicit reject
    host_tree = {"w": np.arange(6).reshape(2, 3)}
    rejected = move_tensor_tree(host_tree, DevicePlacement(device_kind="gpu"))
    assert isinstance(rejected, Failure)
    assert isinstance(rejected.error, RejectTransfer)


def test_device_and_precision_scopes() -> None:
    import jax
    import jax.numpy as jnp

    from spectralmc_tpu.runtime.jax_runtime import device_scope, matmul_precision_scope

    dev = jax.devices("cpu")[0]
    with device_scope(dev), matmul_precision_scope("highest"):
        x = jnp.ones((4, 4)) @ jnp.ones((4, 4))
        assert x.devices() == {dev}
    assert float(x[0, 0]) == 4.0


def test_tree_placement_mixed_and_empty_failures() -> None:
    from spectralmc_tpu.runtime.transfer import get_tree_placement

    # mixed dtypes -> loud failure naming both
    mixed_dtype = {"a": np.ones(3, np.float32), "b": np.ones(3, np.float64)}
    res = get_tree_placement(mixed_dtype)
    assert isinstance(res, Failure) and "mixed dtypes" in res.error
    # empty tree -> failure, not a default placement
    assert isinstance(get_tree_placement({}), Failure)
    # uniform numpy tree -> HostPlacement + dtype string
    ok = get_tree_placement({"a": np.ones(2, np.float32), "b": np.zeros(4, np.float32)})
    assert isinstance(ok, Success)
    placement, dtype = ok.value
    assert isinstance(placement, HostPlacement) and dtype == "float32"


def test_plan_empty_tree_and_scalar_leaf_bytes() -> None:
    from spectralmc_tpu.runtime.transfer import RejectTransfer, plan_tensor_transfer

    assert isinstance(
        plan_tensor_transfer({}, HostPlacement()), RejectTransfer
    )
    # 0-d leaves count itemsize, not zero (np.prod(()) == 1.0 trap)
    move = plan_tensor_transfer(
        {"s": np.float64(3.0)}, DevicePlacement(device_kind="gpu")
    )
    assert isinstance(move, DirectTransfer) and move.total_bytes == 8


def test_move_device_index_clamps_to_available() -> None:
    """Requesting device_index past the fleet clamps to the last device
    (graceful for heterogeneous fleets) rather than raising."""
    tree = {"w": np.arange(4, dtype=np.float32)}
    moved = move_tensor_tree(tree, DevicePlacement(device_kind="cpu", device_index=999))
    assert isinstance(moved, Success)
    np.testing.assert_array_equal(np.asarray(moved.value["w"]), np.arange(4, dtype=np.float32))


def test_compilation_cache_follows_env(monkeypatch) -> None:
    """With JAX_COMPILATION_CACHE_DIR set, no other directory is set."""
    from spectralmc_tpu.runtime import jax_runtime

    calls: list[tuple[str, object]] = []
    monkeypatch.setattr(jax_runtime.jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert jax_runtime.enable_compilation_cache() == "/somewhere/else"
    assert all(k != "jax_compilation_cache_dir" for k, _ in calls)


def test_compilation_cache_defaults_inside_checkout(monkeypatch) -> None:
    """Without the variable the cache sits at the fixed <checkout>/.jax_cache."""
    from pathlib import Path

    from spectralmc_tpu.runtime import jax_runtime

    calls: list[tuple[str, object]] = []
    monkeypatch.setattr(jax_runtime.jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = jax_runtime.enable_compilation_cache()
    root = Path(jax_runtime.__file__).resolve().parents[2]
    assert got == str(root / ".jax_cache")
    assert ("jax_compilation_cache_dir", got) in calls
    assert (root / "pyproject.toml").exists()  # really the checkout root
