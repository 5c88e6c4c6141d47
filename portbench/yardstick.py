"""The benchmark's own arithmetic: the chip's peaks, and the operations and
bytes each piece of work needs, computed from shapes alone.

Nothing here reads the program: a roofline share is this module's count
divided by a time the device trace measured.
"""

from __future__ import annotations

from typing import Tuple

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates, at the
# full 700 W power limit). The port runs float32 matrix products with TF32
# off, so its GEMMs and its float32 attention kernel run on the CUDA cores.
PEAKS = {
    "float32_flops": 67e12,
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}


def attention_bound(bh: int, s: int, d: int, causal: bool, elem_bytes: int = 4,
                    peak_flops: float = PEAKS["float32_flops"],
                    products: int = 2) -> Tuple[float, str]:
    """(bound_ms, bound_by) of one attention launch over (bh, s, d) elements
    of ``elem_bytes`` bytes: ``products`` products of depth or width d (Q K^T
    and P V) at 2 operations per multiply-add over the pairs the mask keeps,
    at ``peak_flops``, against q, k, v read once and o written once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    t_ops = 2 * products * d * pairs * bh / peak_flops
    t_bytes = 4 * bh * s * d * elem_bytes / PEAKS["hbm_bytes_per_s"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def lm_gemm_flops_per_token(n_layers: int, d_model: int, vocab: int, mlp_ratio: int = 4) -> int:
    """Operations of the dense products a token passes through in a
    pre-LN decoder with a tied output head: qkv (d x 3d), the attention's
    output projection (d x d), the MLP (d x rd and rd x d), and the logits
    (d x vocab), at 2 operations per multiply-add."""
    per_layer = 2 * d_model * (3 * d_model + d_model + 2 * mlp_ratio * d_model)
    return n_layers * per_layer + 2 * d_model * vocab


def causal_attention_flops(n_layers: int, d_model: int, seq: int) -> int:
    """Operations of causal attention over one sequence of ``seq`` tokens:
    Q K^T and P V over the s(s+1)/2 pairs the mask keeps, every head of
    every layer (heads x head width = d_model)."""
    return n_layers * 2 * 2 * d_model * (seq * (seq + 1) // 2)


def lm_flops_per_token(n_layers: int, d_model: int, vocab: int, seq: int,
                       mlp_ratio: int = 4) -> float:
    """Model operations a scored token costs in sequences of ``seq``:
    the dense products and its share of the causal attention. At GPT-2
    medium's widths and seq 1024 this is
    24 (24 d^2 + 2 d (S + 1)) + 2 d V = 757,286,912."""
    return (lm_gemm_flops_per_token(n_layers, d_model, vocab, mlp_ratio)
            + causal_attention_flops(n_layers, d_model, seq) / seq)


def keyed_reduce_bytes(rows: int, width: int, value_bytes: int, key_bytes: int,
                       groups: int, outputs: int) -> int:
    """Bytes a keyed aggregate must move: every key and value read once,
    and ``outputs`` tables of ``groups`` x ``width`` values and the
    ``groups`` keys written once."""
    return rows * (key_bytes + width * value_bytes) + groups * (
        outputs * width * value_bytes + key_bytes)


def bytes_bound_s(nbytes: float) -> float:
    """The least time HBM needs to move ``nbytes``."""
    return nbytes / PEAKS["hbm_bytes_per_s"]
