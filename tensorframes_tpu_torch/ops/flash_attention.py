"""Blockwise flash attention: the hand-written CUDA kernel and its plain
PyTorch version.

The counterpart of `tensorframes_tpu/ops/pallas_kernels.py::flash_attention`
(the Pallas TPU kernel `_flash_kernel`). `flash_attention` takes all heads
of a batch at once, ``(BH, S, D)``, and computes
softmax(Q K^T * scale) V per head with the TPU kernel's conventions:
``scale`` defaults to 1/sqrt(D), ``causal`` masks key > query, a row whose
softmax denominator is 0 is guarded to 1, the output has q's dtype.

On a CUDA tensor it launches ``csrc/flash_attention.cu`` (float32, head_dim
a multiple of 8 up to 128, contiguous 16-byte aligned inputs) and raises on
anything else; on a CPU tensor it runs `flash_attention_reference`. There is
no fallback from the kernel to the plain version.
``flash_attention.launches`` counts kernel launches, of both entries.

`flash_attention_lse` is the same function that also returns each row's
log-sum-exp of its scaled scores, ``(BH, S)`` float32, -inf for a row whose
denominator is 0: the softmax statistics with which the ring attention
(`parallel.ring.ring_attention`) merges the launches over its K/V shards.
Its plain version is `flash_attention_lse_reference`; on a CUDA tensor it is
one launch of the same kernel, which then also stores the statistics.

The kernel has no backward (nor has the TPU kernel: JAX cannot
differentiate it). Asked for a gradient, with grad mode on and an input
that requires grad, `flash_attention` raises `AttentionGradientError` on
either device instead of returning an output autograd cannot trace;
training uses `parallel.ring.full_attention`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

__all__ = [
    "AttentionGradientError",
    "flash_attention",
    "flash_attention_lse",
    "flash_attention_lse_reference",
    "flash_attention_reference",
]

_NEG_INF = -1e30  # the TPU kernel's mask value
_BLOCK_Q = 64  # query rows per block of csrc/flash_attention.cu (kBlockQ)
_MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y, which counts query tiles


class AttentionGradientError(RuntimeError):
    """`flash_attention` was asked for a gradient; the kernel has none."""


def _plain(q, k, v, causal, scale):
    """The kernel's arithmetic in plain PyTorch: (unnormalised output, row
    max m, denominator l), with m over the scores scaled and masked to -1e30."""
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
    return torch.matmul(p, v.float()), m, p.sum(dim=-1, keepdim=True)


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
    acc, _, l = _plain(q, k, v, causal, scale)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l).to(q.dtype)


def flash_attention_lse_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `flash_attention_lse`: the output of
    `flash_attention_reference` and each row's log-sum-exp of its scaled
    scores, ``m + ln(l)`` in float32 (-inf where l is 0). Shapes
    ``(..., S, D)`` -> ``(..., S, D)``, ``(..., S)``."""
    acc, m, l = _plain(q, k, v, causal, scale)
    lse = torch.where(l == 0, torch.full_like(l, -math.inf), m + torch.log(l))
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l).to(q.dtype), lse[..., 0]


def _check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the CUDA kernel takes: three contiguous, 16-byte aligned float32
    (BH, S, D) tensors on one CUDA device, D a multiple of 8 up to 128, at
    most 65535 query tiles of 64 rows."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype is not torch.float32:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k and v must share a device")
        if t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} must start on a 16-byte boundary "
                "(the kernel stages rows with 16-byte copies)"
            )
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
    if -(-q.shape[1] // _BLOCK_Q) > _MAX_GRID_Y:
        raise ValueError(
            f"flash_attention: at most {_MAX_GRID_Y} query tiles of {_BLOCK_Q} rows "
            f"per launch, got seq {q.shape[1]}"
        )


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from ._cuda_build import load_library

        lib = load_library("flash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tfs_flash_attention_f32.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, f32, i32, ptr,
        ]
        lib.tfs_flash_attention_f32.restype = i32
        lib.tfs_flash_attention_lse_f32.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, f32, i32, ptr,
        ]
        lib.tfs_flash_attention_lse_f32.restype = i32
        lib.tfs_cuda_error_string.argtypes = [i32]
        lib.tfs_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _refuse_grad(q, k, v, what: str) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise AttentionGradientError(
            f"{what} has no backward: its output would carry no "
            "gradient to q, k and v. Train through "
            "tensorframes_tpu_torch.parallel.ring.full_attention (what "
            "TransformerLM.loss and train_step use) or "
            "ring_attention_reference, or score under torch.no_grad()"
        )


def _launch(q, k, v, causal, scale, with_lse: bool):
    """One launch of the kernel on CUDA tensors: (out, lse or None)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check_kernel_args(q, k, v)
    bh, seq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = torch.empty(bh, seq, dtype=torch.float32, device=q.device) if with_lse else None
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if with_lse:
            rc = lib.tfs_flash_attention_lse_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                bh, seq, d, float(scale), int(bool(causal)), stream,
            )
        else:
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
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over ``(BH, S, D)`` tensors: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Raises
    `AttentionGradientError` when autograd would need its gradient."""
    _refuse_grad(q, k, v, "flash_attention")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    return _launch(q, k, v, causal, scale, with_lse=False)[0]


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention` and each row's log-sum-exp of its scaled scores:
    ``(out (BH, S, D), lse (BH, S) float32)``. One launch of the kernel for
    CUDA tensors (counted in ``flash_attention.launches``), the plain
    version for CPU tensors; raises `AttentionGradientError` when autograd
    would need its gradient."""
    _refuse_grad(q, k, v, "flash_attention_lse")
    if q.device.type == "cpu":
        return flash_attention_lse_reference(q, k, v, causal=causal, scale=scale)
    return _launch(q, k, v, causal, scale, with_lse=True)


flash_attention.launches = 0
