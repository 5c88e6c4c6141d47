"""Blockwise flash attention: the hand-written CUDA kernel and its plain
PyTorch version.

The counterpart of `tensorframes_tpu/ops/pallas_kernels.py::flash_attention`
(the Pallas TPU kernel `_flash_kernel`). `flash_attention` takes all heads
of a batch at once, ``(BH, S, D)``, and computes
softmax(Q K^T * scale) V per head with the TPU kernel's conventions:
``scale`` defaults to 1/sqrt(D), ``causal`` masks key > query, a row whose
softmax denominator is 0 is guarded to 1, the output has q's dtype.

On a CUDA tensor it launches ``csrc/flash_attention.cu`` (float32, head_dim
a multiple of 8 up to 128, contiguous inputs) and raises on anything else;
on a CPU tensor it runs `flash_attention_reference`. There is no fallback
from the kernel to the plain version. ``flash_attention.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

__all__ = ["flash_attention", "flash_attention_reference"]

_NEG_INF = -1e30  # the TPU kernel's mask value


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function: full scores in
    float32, masked to -1e30, max-subtracted softmax with the l == 0 guard.
    Shapes ``(..., S, D)``."""
    seq, d = q.shape[-2], q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        pos = torch.arange(seq, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (torch.matmul(p, v.float()) / l).to(q.dtype)


def _check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the CUDA kernel takes: three contiguous float32 (BH, S, D)
    tensors on one CUDA device, D a multiple of 8 up to 128."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype is not torch.float32:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k and v must share a device")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash_attention: q, k, v must share one (BH, S, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    d = q.shape[-1]
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(
            f"flash_attention: head_dim {d} is not a multiple of 8 in [8, 128]"
        )
    if q.shape[0] > 65535:
        raise ValueError("flash_attention: at most 65535 heads per launch")


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from ._cuda_build import load_library

        lib = load_library("flash_attention")
        lib.tfs_flash_attention_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.tfs_flash_attention_f32.restype = ctypes.c_int
        lib.tfs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tfs_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over ``(BH, S, D)`` tensors: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check_kernel_args(q, k, v)
    bh, seq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tfs_flash_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, seq, d, float(scale), int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "flash_attention kernel launch failed: "
            f"{lib.tfs_cuda_error_string(rc).decode()} (cudaError {rc})"
        )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
