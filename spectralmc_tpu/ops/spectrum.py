"""Characteristic-function (DFT) estimator of the MC payoff distribution.

Capability parity with the reference's cuFFT path
(``/root/reference/src/spectralmc/gbm_trainer.py:806-817``, ``_simulate_fft``):
the discounted put-payoff vector is reshaped to
``[batches_per_mc_run, network_size]``, FFT'd along the network axis, and
batch-averaged — producing the complex spectrum the CVNN regresses.

This is ``jnp.fft.fft`` (XLA FFT); it fuses into the jitted train step,
so the reference's DLPack CuPy→Torch hop (gbm_trainer.py:1556) has no
counterpart. ``mean_spectrum_psum`` is the sharded variant: each device FFTs
its local batch rows and the batch-mean is a single ``psum`` over the mesh's
path axis (per SURVEY.md §2.9's DP design).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def payoff_spectrum(
    payoffs: jax.Array, *, batches: int, network_size: int
) -> jax.Array:
    """Batch-averaged DFT ``[network_size]`` complex of a flat payoff vector.

    The DFT is linear, so ``mean_r FFT(row_r) == FFT(mean_r row_r)`` — one
    ``network_size``-point FFT of the row-mean replaces ``batches`` row FFTs.
    The reference runs the batched cuFFT then means (gbm_trainer.py:814-817);
    at production scale that streams the full complex [batches, network]
    tensor through HBM for no mathematical reason.
    """
    rows = payoffs.reshape(batches, network_size)
    return jnp.fft.fft(jnp.mean(rows, axis=0))


def local_spectrum_sum(
    payoffs: jax.Array, *, batches: int, network_size: int
) -> jax.Array:
    """Per-shard un-normalized spectrum sum (combine with psum + divide)."""
    rows = payoffs.reshape(batches, network_size)
    return jnp.fft.fft(jnp.sum(rows, axis=0))


def mean_spectrum_psum(
    payoffs: jax.Array, *, batches: int, network_size: int, axis_name: str, total_batches: int
) -> jax.Array:
    """Sharded batch-mean spectrum: local FFT+sum, one ``psum`` over the mesh."""
    local = local_spectrum_sum(payoffs, batches=batches, network_size=network_size)
    return jax.lax.psum(local, axis_name) / total_batches


def spectrum_to_price(spectrum: jax.Array) -> jax.Array:
    """Invert a spectrum back to E[discounted payoff].

    Parity with the reference's inference path (gbm_trainer.py:1709-1767):
    ``ifft`` recovers the averaged payoff sequence; its mean is the price.
    Algebraically that mean is ``spectrum[0] / network_size`` — but we keep
    the full ifft so callers can inspect the imaginary residue as a model-
    quality diagnostic, exactly as the reference warns on residue > 1e-6.
    """
    recovered = jnp.fft.ifft(spectrum)
    return jnp.mean(recovered)
