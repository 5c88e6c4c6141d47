"""Kimi Delta Attention's recurrence: the hand-written CUDA kernel and its
plain PyTorch version.

`kda` takes the inputs of a KDA layer's token mixer, each ``(B, S, H, D)``
(q and k L2-normalised by the caller, the log-decay g, v) and beta ``(B,
S, H)``, and returns o ``(B, S, H, D)``: per sequence and head, with the
state S (D x D) zero at the sequence's start, token by token

- S' = Diag(exp(g_t)) S;
- u_t = v_t - S'^T k_t;
- S = S' + beta_t k_t u_t^T;
- o_t = scale * S^T q_t (``scale`` defaults to D^-1/2).

On a CUDA tensor (D 128, computed in float32) it is one launch of
``csrc/kda.cu`` (built at first use,
`_cuda_build.load_library`), the state held on chip and never written out.
On a CPU tensor it runs `kda_reference`, the same steps as a loop of torch
operations, batched over sequences and heads. There is no fallback from the
kernel to the plain version. ``kda.launches`` counts kernel launches, and
so does the profiling counter ``kda.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.profiling import count as _count
from ._cuda_build import check, load_library

__all__ = ["kda", "kda_reference", "HEAD_DIM"]

HEAD_DIM = 128  # dk = dv, the only width csrc/kda.cu takes (kDim)

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# csrc/kda.cu's C entries: name -> (argtypes, restype)
_ENTRIES = {
    "tfs_kda": ([_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I64, _I32, ctypes.c_float, _PTR],
                _I32),
    "tfs_kda_error_string": ([_I32], ctypes.c_char_p),
}


def kda_reference(q: torch.Tensor, k: torch.Tensor, g: torch.Tensor, beta: torch.Tensor,
                  v: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """The recurrence as a step loop of torch operations, batched over
    sequences and heads, in the inputs' dtype."""
    b, s, h, dk = q.shape
    scale = dk ** -0.5 if scale is None else scale
    state = q.new_zeros(b, h, dk, v.shape[-1])
    out = torch.empty_like(v)
    for t in range(s):
        state = state * g[:, t].exp().unsqueeze(-1)
        kt = k[:, t].unsqueeze(-1)
        u = v[:, t] - (state * kt).sum(-2)
        state = state + beta[:, t, :, None, None] * kt * u.unsqueeze(-2)
        out[:, t] = scale * (state * q[:, t].unsqueeze(-1)).sum(-2)
    return out


def _check(q, k, g, beta, v) -> None:
    if q.dim() != 4 or any(t.shape != q.shape for t in (k, g, v)):
        raise ValueError(f"kda: q, k, g, v must share one (B, S, H, D) shape, got "
                         f"{[tuple(t.shape) for t in (q, k, g, v)]}")
    if beta.shape != q.shape[:3]:
        raise ValueError(f"kda: beta {tuple(beta.shape)} against q {tuple(q.shape)}")
    if any(t.device != q.device for t in (k, g, beta, v)):
        raise ValueError("kda: the inputs must share a device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it: float32, contiguous, 16-byte aligned."""
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, g, beta, v, scale: float) -> torch.Tensor:
    b, s, h, _ = q.shape
    q, k, g, beta, v = (_aligned(t) for t in (q, k, g, beta, v))
    out = torch.empty_like(v)
    if out.numel() == 0:
        return out
    lib = load_library("kda", _ENTRIES)
    with torch.cuda.device(q.device):
        rc = lib.tfs_kda(q.data_ptr(), k.data_ptr(), g.data_ptr(), beta.data_ptr(), v.data_ptr(),
                         out.data_ptr(), b, s, h, scale,
                         torch.cuda.current_stream(q.device).cuda_stream)
    check(rc, "kda kernel launch", lib.tfs_kda_error_string)
    kda.launches += 1
    _count("kda.launches")
    return out


def kda(q: torch.Tensor, k: torch.Tensor, g: torch.Tensor, beta: torch.Tensor, v: torch.Tensor,
        scale: Optional[float] = None) -> torch.Tensor:
    """o ``(B, S, H, D)`` of the recurrence (module docstring): the CUDA
    kernel for CUDA tensors (D 128), in float32; `kda_reference` for CPU
    tensors (any D). Raises `ValueError` for shapes or devices that do not
    match."""
    _check(q, k, g, beta, v)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return kda_reference(q, k, g, beta, v, scale)
    if q.device.type != "cuda" or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"kda: no kernel for D {q.shape[-1]} on {q.device} (the kernel takes "
                         f"D {HEAD_DIM} on a CUDA card)")
    return _launch(q, k, g, beta, v, scale)


kda.launches = 0
