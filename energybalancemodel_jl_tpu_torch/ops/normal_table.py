"""The stand-alone draw kernel: the wrapper of ``csrc/normal_table.cu`` and
its plain version.

Port of the TPU probe ``scripts/tpu_check.py:468`` (a ``pallas_call`` of the
JAX package's in-kernel generator ``pallas_year.py::_gen_noise_xk``): the
``(nt, K)`` float32 white-noise table of ``(K, 2)`` uint32 member keys,
bitwise ``jax.random.normal``. The year kernels draw the same numbers with
the same device code (``csrc/prng.cuh``); this kernel checks that code on
its own, and :func:`normal_from_bits` takes raw 32-bit words, so every
mantissa the pipeline can see is checkable.

Each wrapper runs its plain version (:mod:`.prng`) on a CPU tensor and
launches its kernel on a CUDA tensor, or raises.
"""
from __future__ import annotations

import torch

from . import _build, prng
from ._year import keys_tensor

__all__ = ["normal_table", "normal_from_bits"]


def normal_table(keys, nt: int, device=None) -> torch.Tensor:
    """``(nt, K)`` float32 draws of ``(K, 2)`` uint32 keys (numpy, or an
    integer tensor) on ``device`` (default: the keys' device, else the
    CPU). On a CUDA device this launches the kernel (counted in
    ``normal_table.launches``); on the CPU it runs
    :func:`.prng.normal_table`."""
    if device is None:
        device = keys.device if torch.is_tensor(keys) else torch.device("cpu")
    device = torch.device(device)
    K = int(keys.shape[0])
    k = keys_tensor(keys, K, device)
    if device.type == "cpu":
        return prng.normal_table(k, nt)
    if device.type != "cuda":
        raise ValueError(f"normal_table has no kernel for device {device}")
    out = torch.empty((nt, K), dtype=torch.float32, device=device)
    _build.launch_raw("ebm_normal_table", device, k.data_ptr(), out.data_ptr(), K, int(nt))
    _build.count(normal_table)
    return out


normal_table.launches = 0


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Float32 normal draws of a 1-D tensor of 32-bit words (int64 values in
    ``[0, 2^32)``, or int32 with the same bits). On a CUDA tensor this
    launches the kernel's bits entry point (counted in
    ``normal_from_bits.launches``); on the CPU it runs
    :func:`.prng.normal_from_bits`."""
    if bits.ndim != 1:
        raise ValueError(f"normal_from_bits takes a 1-D tensor, got shape {tuple(bits.shape)}")
    if bits.device.type == "cpu":
        return prng.normal_from_bits(bits.to(torch.int64) & 0xFFFFFFFF)
    if bits.device.type != "cuda":
        raise ValueError(f"normal_from_bits has no kernel for device {bits.device}")
    words = bits.to(torch.int32).contiguous() if bits.dtype != torch.int32 else bits.contiguous()
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    _build.launch_raw("ebm_normal_bits", bits.device, words.data_ptr(), out.data_ptr(),
                      int(bits.shape[0]))
    _build.count(normal_from_bits)
    return out


normal_from_bits.launches = 0
