"""The benchmark's arithmetic at the cells' shapes."""

import pytest

from portbench import yardstick as y

D, L, V = 1024, 24, 50257  # GPT-2 medium


def test_gpt2_medium_flops_per_token():
    # 24 (24 d^2 + 2 d (S + 1)) + 2 d V
    assert y.lm_flops_per_token(L, D, V, 1024) == 757_286_912
    assert y.lm_flops_per_token(L, D, V, 128) == 713_246_720
    assert y.lm_gemm_flops_per_token(L, D, V) == 706_906_112


def test_attention_causal_flops_match_the_per_token_share():
    s = 1024
    assert y.causal_attention_flops(L, D, s) == 24 * 2 * D * (s + 1) * s


@pytest.mark.parametrize("bh,s,d,want_ms,by", [
    (32, 2048, 64, 0.256541, "operations"),  # the LM shape of the kernel's table
    (32, 1024, 64, 0.064166, "operations"),  # gpt2m.score.s1024: 2 sequences x 16 heads
    (256, 128, 64, 0.0100162, "bytes"),  # gpt2m.score.s128: 16 sequences x 16 heads
])
def test_attention_bound(bh, s, d, want_ms, by):
    ms, bound_by = y.attention_bound(bh, s, d, causal=True)
    assert ms == pytest.approx(want_ms, rel=1e-4)
    assert bound_by == by


def test_attention_bound_is_bytes_bound_when_short():
    ms, by = y.attention_bound(1, 1, 64, causal=True)
    assert by == "bytes" and ms == pytest.approx(4 * 64 * 4 / 3.35e12 * 1e3)


def test_keyed_reduce_bytes_at_config_4():
    n = y.keyed_reduce_bytes(100_000_000, 8, 4, 8, 16, 2)
    assert n == 100_000_000 * 40 + 16 * (2 * 32 + 8)
    assert y.bytes_bound_s(n) * 1e3 == pytest.approx(1.19403, rel=1e-4)


def test_peaks_are_the_data_sheet_s():
    assert y.PEAKS["float32_flops"] == 67e12
    assert y.PEAKS["hbm_bytes_per_s"] == 3.35e12
