"""utils/flops.py: the MFU accounting must match hand counts.

The published MFU figures (bench.py extras ``train_step_mfu_pct``) are only
as falsifiable as this arithmetic, so the conventions in the module
docstring are pinned here against small hand-counted cases.
"""

from __future__ import annotations

import numpy as np
import pytest

from spectralmc_tpu.utils.flops import (
    PEAK_MATMUL_FLOPS,
    fft_flops,
    matmul_forward_flops,
    mfu,
    sim_path_steps,
    train_step_matmul_flops,
)


def _params() -> dict:
    # one ComplexLinear (3 -> 4): w_re/w_im are the 2-D matmul leaves,
    # biases are 1-D and must not be counted
    return {
        "w_re": np.zeros((3, 4), dtype=np.float32),
        "w_im": np.zeros((3, 4), dtype=np.float32),
        "b_re": np.zeros(4, dtype=np.float32),
        "b_im": np.zeros(4, dtype=np.float32),
    }


def test_forward_flops_hand_count() -> None:
    # per 2-D leaf: 4*B*in*out = 4*2*3*4 = 96; two leaves -> 192
    # (= the familiar 8*B*in*out for one complex matmul)
    assert matmul_forward_flops(_params(), batch_size=2) == 192


def test_train_step_is_three_times_forward() -> None:
    assert train_step_matmul_flops(_params(), batch_size=2) == 3 * 192


def test_nested_pytree_and_scalar_leaves() -> None:
    tree = {"layer_0": _params(), "layer_1": {"w_re": np.zeros((4, 2))}}
    # 192 + 4*2*4*2 = 192 + 64
    assert matmul_forward_flops(tree, batch_size=2) == 192 + 64


def test_fft_flops_convention() -> None:
    # 5*N*log2(N) per contract: N=8 -> 120; B=4 -> 480
    assert fft_flops(4, 8) == 480


def test_sim_path_steps() -> None:
    assert sim_path_steps(2, 3, 5, 7) == 2 * 3 * 5 * 7


H100 = "NVIDIA H100 80GB HBM3"


def test_mfu_fraction() -> None:
    # 1 GFLOP/step at 1000 steps/s = 1 TFLOP/s against 67 TFLOP/s float32
    tflops, frac = mfu(1e9, 1000.0, device_kind=H100)
    assert abs(tflops - 1.0) < 1e-12
    assert abs(frac - 1e12 / 67e12) < 1e-15


def test_mfu_precision_selects_the_peak() -> None:
    _, frac = mfu(1e9, 1000.0, device_kind=H100, precision="bfloat16")
    assert abs(frac - 1e12 / PEAK_MATMUL_FLOPS[H100]["bfloat16"]) < 1e-15


@pytest.mark.parametrize(
    "device_kind,precision", [("NVIDIA A100-SXM4-80GB", "highest"), ("cpu", "highest"), (H100, "fp8")]
)
def test_mfu_unknown_device_or_precision_raises(device_kind: str, precision: str) -> None:
    with pytest.raises(ValueError, match="no peak matmul rate"):
        mfu(1e9, 1000.0, device_kind=device_kind, precision=precision)
