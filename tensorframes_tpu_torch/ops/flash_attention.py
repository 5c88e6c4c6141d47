"""Blockwise flash attention: the hand-written CUDA kernel and its plain
PyTorch version.

The counterpart of `tensorframes_tpu/ops/pallas_kernels.py::flash_attention`
(the Pallas TPU kernel `_flash_kernel`). `flash_attention` takes q, k and v
of one shape ``(..., S, D)``: JAX's ``(S, D)``, the model's ``(BH, S, D)``
(all heads of a batch at once) or any other leading dimensions. It computes
softmax(Q K^T * scale) V per head with the TPU kernel's conventions:
``scale`` defaults to 1/sqrt(D), ``causal`` masks key > query, a row whose
softmax denominator is 0 is guarded to 1, the arithmetic is float32 whatever
the inputs' dtype, and the output has q's dtype.

On a CUDA tensor it launches a kernel of ``csrc/`` (float32, float16 and
bfloat16 builds) through one layout step,
`_kernel_layout`, a plain function the CPU tests call too: the leading
dimensions flattened to BH; float32, float16 and bfloat16 passed as they
are when q, k and v share the dtype, any other dtype cast to float32 (what
the Pallas kernel does to each block); D zero-padded to a multiple of 8
(zero columns add 0 to every score); a contiguous, 16-byte aligned copy of
a strided or misaligned input. The result is sliced and reshaped back and
cast to q's dtype (a float cast to an integer truncates, as JAX's
``astype`` does). The library's dispatch picks the kernel: bf16 and fp16
heads of every width run on the tensor cores (``flash_attention_tc.cuh``,
route ``tensor_core``), 128-row query tiles, up to 256 wide (padded) in one
block, wider in slices of at most 256 output columns, each block computing
the scores over the whole head; float32 heads up to 128 wide run on the
CUDA cores in one block's registers (``flash_attention.cuh``, route
``cuda_core``), wider ones in slices of 256 output columns whose scores each
block computes once (``flash_attention.cuh``, route ``wide``). On a CPU
tensor it runs `flash_attention_reference`. There is no fallback from a
kernel to another or to the plain version.
``flash_attention.launches`` counts kernel launches, of both entries;
``flash_attention.launches_by_route`` counts them by the kernel the library
reports it launched (``cuda_core``, ``wide``, ``tensor_core``).

`flash_attention_lse` is the same function that also returns each row's
log-sum-exp of its scaled scores, ``(..., S)`` float32, -inf for a row whose
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
# the kernel's builds: element type -> (C entry suffix, library of csrc/)
_BUILDS = {
    torch.float32: ("f32", "flash_attention"),
    torch.float16: ("f16", "flash_attention_f16"),
    torch.bfloat16: ("bf16", "flash_attention_bf16"),
}
_BLOCK_Q = 64  # query rows per block of csrc/flash_attention.cuh (kBlockQ)
_TC_BLOCK_Q = 128  # query rows per block of csrc/flash_attention_tc.cuh (kTcRows)
_SLICE_D = 128  # widest head of the float32 one-slice kernel (kSliceD)
_TC_SLICE_D = 256  # widest head one tensor-core block takes whole, past it a slice (kTcSliceD)
_WIDE_SLICE_D = 256  # output columns per block of the float32 wide kernel (kWideSliceD)
# the kernels, by the number tfs_flash_attention_last_route reports
_ROUTES = ("cuda_core", "wide", "tensor_core")
_MAX_BLOCKS = 2**31 - 1  # CUDA's limit on gridDim.x, which counts the blocks


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
    """What no layout makes fit the kernel: q, k and v must share one
    ``(..., S, D)`` shape, D at least 1, and one device."""
    if q.dim() < 2 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash_attention: q, k, v must share one (..., S, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[-1] == 0:
        raise ValueError("flash_attention: head_dim 0")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must share a device")


def _kernel_blocks(dtype: torch.dtype, bh: int, seq: int, d8: int) -> int:
    """The thread blocks of the kernel the library picks for (BH, S, D8):
    bf16 and fp16 heads take 128-row query tiles in ceil(D8 / _TC_SLICE_D)
    slices of output columns (the tensor-core kernels); float32 heads up to
    _SLICE_D 64-row tiles; wider float32 heads 64-row tiles in slices of
    _WIDE_SLICE_D output columns (the wide kernel)."""
    if dtype in (torch.float16, torch.bfloat16):
        return -(-d8 // _TC_SLICE_D) * bh * -(-seq // _TC_BLOCK_Q)
    if d8 <= _SLICE_D:
        return bh * -(-seq // _BLOCK_Q)
    return -(-d8 // _WIDE_SLICE_D) * bh * -(-seq // _BLOCK_Q)


def _kernel_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale):
    """The layout step of every CUDA launch, on any device: ``(q3, k3, v3,
    scale, restore)``. q3, k3 and v3 are what the kernel takes, contiguous
    16-byte aligned ``(BH, S, D8)`` tensors of one of its element types, D8
    the head width rounded up to a multiple of 8 with zero columns;
    ``scale`` is 1/sqrt(D) of the true D when None; ``restore(out3, lse3)``
    turns the kernel's ``(BH, S, D8)`` output and ``(BH, S)`` log-sum-exp
    (or None) back into ``(..., S, D)`` in q's dtype and ``(..., S)``
    float32."""
    _check_kernel_args(q, k, v)
    *lead, seq, d = q.shape
    bh = math.prod(lead)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    same = k.dtype == q.dtype and v.dtype == q.dtype
    dtype = q.dtype if same and q.dtype in _BUILDS else torch.float32
    d8 = -(-d // 8) * 8
    blocks = _kernel_blocks(dtype, bh, seq, d8)
    if blocks > _MAX_BLOCKS:
        raise ValueError(
            f"flash_attention: {blocks} thread blocks for (BH {bh}, S {seq}, D {d}), "
            f"one launch takes at most {_MAX_BLOCKS}"
        )

    def prep(t):
        t = t.reshape(bh, seq, d).to(dtype)
        if d8 != d:
            t = torch.nn.functional.pad(t, (0, d8 - d))
        # .contiguous() keeps a contiguous view that starts off a 16-byte
        # boundary; the kernel stages rows with 16-byte copies
        if not t.is_contiguous() or t.data_ptr() % 16:
            t = t.clone(memory_format=torch.contiguous_format)
        return t

    def restore(out, lse):
        out = out[..., :d].reshape(*lead, seq, d).to(q.dtype)
        return out, None if lse is None else lse.reshape(*lead, seq)

    return prep(q), prep(k), prep(v), float(scale), restore


_libs = {}


def _kernel_entry(dtype: torch.dtype, with_lse: bool):
    """(the C entry for ``dtype``'s build, its library), built and loaded
    on first use."""
    sfx, name = _BUILDS[dtype]
    lib = _libs.get(sfx)
    if lib is None:
        from ._cuda_build import load_library

        lib = load_library(name)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for entry, lse_arg in ((f"tfs_flash_attention_{sfx}", []),
                               (f"tfs_flash_attention_lse_{sfx}", [ptr])):
            fn = getattr(lib, entry)
            fn.argtypes = [ptr, ptr, ptr, ptr, *lse_arg, i32, i32, i32, f32, i32, ptr]
            fn.restype = i32
        lib.tfs_cuda_error_string.argtypes = [i32]
        lib.tfs_cuda_error_string.restype = ctypes.c_char_p
        lib.tfs_flash_attention_last_route.argtypes = []
        lib.tfs_flash_attention_last_route.restype = i32
        _libs[sfx] = lib
    return getattr(lib, f"tfs_flash_attention{'_lse' if with_lse else ''}_{sfx}"), lib


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
    """One launch of the kernel on CUDA tensors, through the layout step:
    (out, lse or None)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    q3, k3, v3, scale, restore = _kernel_layout(q, k, v, scale)
    bh, seq, d8 = q3.shape
    out = torch.empty_like(q3)
    lse = torch.empty(bh, seq, dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return restore(out, lse)
    entry, lib = _kernel_entry(q3.dtype, with_lse)
    lse_arg = (lse.data_ptr(),) if with_lse else ()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = entry(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), *lse_arg,
            bh, seq, d8, scale, int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "flash_attention kernel launch failed: "
            f"{lib.tfs_cuda_error_string(rc).decode()} (cudaError {rc})"
        )
    route = lib.tfs_flash_attention_last_route()
    if not 0 <= route < len(_ROUTES):
        raise RuntimeError(f"flash_attention: the library reports no kernel launched ({route})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[_ROUTES[route]] += 1
    return restore(out, lse)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Attention over q, k, v of one shape ``(..., S, D)``, output in q's
    dtype: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. ``block_q`` and ``block_k`` are JAX's keywords: they choose the
    TPU kernel's tiles, which change only the order in which its sums
    round, and leave the CUDA kernel's tiles as they are. Raises
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
    block_q: int = 128,
    block_k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention` and each row's log-sum-exp of its scaled scores:
    ``(out (..., S, D), lse (..., S) float32)``. One launch of the kernel for
    CUDA tensors (counted in ``flash_attention.launches``), the plain
    version for CPU tensors; ``block_q`` / ``block_k`` as in
    `flash_attention`. Raises `AttentionGradientError` when autograd would
    need its gradient."""
    _refuse_grad(q, k, v, "flash_attention_lse")
    if q.device.type == "cpu":
        return flash_attention_lse_reference(q, k, v, causal=causal, scale=scale)
    return _launch(q, k, v, causal, scale, with_lse=True)


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(_ROUTES, 0)
