"""Analytic FLOP accounting for the fused train step (MFU/roofline).

This module counts the matmul half of the train step — the complex matmuls
and the FFT — so a measured steps/s figure comes with a utilization
statement instead of an unfalsifiable rate. The reference
publishes raw steps/s only (its benchmark harness times
``gbm_trainer.train()`` wall clock and nothing else), so this exceeds parity.

Counting conventions (stated so the numbers are reproducible):

* A real ``[B, in] @ [in, out]`` matmul is ``2*B*in*out`` FLOPs
  (multiply+add), the standard accounting.
* A ComplexLinear stores ``w_re``/``w_im`` and computes 4 real dots
  (models/cvnn.py); each 2-D weight leaf therefore appears in 2 forward
  dots → ``4*B*in*out`` forward FLOPs per leaf, summed over both leaves of
  each complex weight gives the familiar ``8*B*in*out`` per complex matmul.
* Backward re-uses each weight twice (input-grad and weight-grad dots of the
  same shape) → total fwd+bwd = 3x forward. Adam and the activations are
  elementwise noise at these shapes and are not counted.
* An N-point complex FFT is ``5*N*log2(N)`` FLOPs (Cooley–Tukey convention).
  The DFT-linearity reduction (ops/spectrum.py::payoff_spectrum) means ONE
  FFT per contract, not one per MC row.
"""

from __future__ import annotations

import math

import jax

from spectralmc_tpu.core.aliases import PyTree

#: Dense peak matmul rates in FLOP/s by ``jax.devices()[0].device_kind`` and
#: the matmul precision the step runs at (``jax_default_matmul_precision``).
#: Source: NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W
#: power limit: 67 TFLOP/s float32 outside the tensor cores — what
#: ``highest`` runs, since it forbids TF32 — 495 TFLOP/s TF32 and 989 TFLOP/s
#: bf16. A device that is not here is an error, not a default.
PEAK_MATMUL_FLOPS: dict[str, dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"highest": 67e12, "tensorfloat32": 495e12, "bfloat16": 989e12},
}


def peak_matmul_flops(device_kind: str, precision: str = "highest") -> float:
    """The table's peak for this device and precision; raises for a device
    or precision the table does not know."""
    try:
        return PEAK_MATMUL_FLOPS[device_kind][precision]
    except KeyError:
        raise ValueError(
            f"no peak matmul rate for device_kind={device_kind!r} at "
            f"precision={precision!r}; known: {sorted(PEAK_MATMUL_FLOPS)}"
        ) from None


def matmul_forward_flops(params: PyTree, batch_size: int) -> int:
    """Forward matmul FLOPs of one CVNN apply at ``batch_size`` rows.

    Walks the params pytree: every 2-D leaf of shape ``(in, out)`` is a real
    weight used by 2 forward dots (see module conventions).
    """
    total = 0
    for leaf in jax.tree_util.tree_leaves(params):
        if getattr(leaf, "ndim", 0) == 2:
            d_in, d_out = int(leaf.shape[0]), int(leaf.shape[1])
            total += 4 * batch_size * d_in * d_out
    return total


def train_step_matmul_flops(params: PyTree, batch_size: int) -> int:
    """Fwd+bwd matmul FLOPs of one fused train step (3x forward)."""
    return 3 * matmul_forward_flops(params, batch_size)


def fft_flops(batch_size: int, network_size: int) -> int:
    """FLOPs of the per-contract spectrum FFTs in one train step."""
    return batch_size * int(5 * network_size * math.log2(network_size))


def sim_path_steps(
    batch_size: int, rows: int, cols: int, timesteps: int
) -> int:
    """MC path-steps simulated per train step.

    Path-steps, not FLOPs: the sim's currency is the per-step update, whose
    bound is the generator's integer work and the transcendentals, not a
    matmul FLOP count.
    """
    return batch_size * rows * cols * timesteps


def mfu(
    matmul_flops_per_step: float,
    steps_per_sec: float,
    *,
    device_kind: str,
    precision: str = "highest",
) -> tuple[float, float]:
    """(achieved TFLOP/s, fraction of the device's peak at ``precision``)
    for a measured step rate. Raises for a device not in the table."""
    peak = peak_matmul_flops(device_kind, precision)
    achieved = matmul_flops_per_step * steps_per_sec
    return achieved / 1e12, achieved / peak
