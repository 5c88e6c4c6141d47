"""The plain references against the port at a tiny size on the CPU, and
the keyed reference against NumPy."""

import numpy as np
import pytest
import torch

from portbench.drivers import aggregate as agg
from portbench.drivers import fn_map_blocks_lm as lm
from portbench.reference import gpt2, keyed_meanvar

CPU = torch.device("cpu")
TINY = {"n_embd": 32, "n_head": 4, "n_layer": 2, "n_positions": 24, "vocab_size": 61,
        "initializer_range": 0.02}
TRAFFIC = {"sequences": 3, "seq_len": 24}


def _port_model(weights):
    from tensorframes_tpu_torch.models import TransformerLM

    model = TransformerLM(vocab=TINY["vocab_size"], d_model=TINY["n_embd"],
                          n_heads=TINY["n_head"], n_layers=TINY["n_layer"],
                          max_seq=TINY["n_positions"], device="cpu")
    with torch.no_grad():
        for k, v in weights.items():
            model.params[k].copy_(v)
    return model


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_gpt2_reference_matches_the_port(seed):
    weights = lm.make_weights(TINY, seed, CPU)
    tokens = lm.make_tokens(TINY, TRAFFIC, seed, 0, CPU)
    want = gpt2.logits(weights, tokens, TINY["n_head"], TINY["n_layer"])
    got = _port_model(weights)(tokens)
    assert got.shape == (3, 24, 61)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_gpt2_reference_is_causal_and_blockwise():
    weights = lm.make_weights(TINY, 5, CPU)
    tokens = lm.make_tokens(TINY, TRAFFIC, 5, 1, CPU)
    full = gpt2.logits(weights, tokens, TINY["n_head"], TINY["n_layer"])
    prefix = gpt2.logits(weights, tokens[:, :10], TINY["n_head"], TINY["n_layer"])
    torch.testing.assert_close(prefix, full[:, :10], rtol=1e-5, atol=1e-6)
    blocks = torch.cat(list(gpt2.logits_blocks(weights, tokens, TINY["n_head"],
                                               TINY["n_layer"], 2)))
    torch.testing.assert_close(blocks, full, rtol=1e-5, atol=1e-6)


def test_gpt2_weights_follow_the_seed():
    a, b = lm.make_weights(TINY, 9, CPU), lm.make_weights(TINY, 9, CPU)
    c = lm.make_weights(TINY, 10, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert a["embed"].std().item() == pytest.approx(0.02, rel=0.1)


def test_matmul_precision_restores_the_flags():
    before = torch.backends.cuda.matmul.allow_tf32
    with gpt2.matmul_precision(tf32=not before):
        assert torch.backends.cuda.matmul.allow_tf32 is (not before)
    assert torch.backends.cuda.matmul.allow_tf32 is before


MEANVAR = {"rows_per_card": 5000, "width": 8, "keys": 16}


def _numpy_means(keys, values, groups):
    k, v = keys.numpy(), values.numpy().astype(np.float64)
    n = np.bincount(k, minlength=groups)
    m = np.stack([np.bincount(k, weights=v[:, j], minlength=groups) for j in range(v.shape[1])], 1)
    q = np.stack([np.bincount(k, weights=v[:, j] ** 2, minlength=groups)
                  for j in range(v.shape[1])], 1)
    present = np.nonzero(n)[0]
    return present, m[present] / n[present, None], q[present] / n[present, None]


@pytest.mark.parametrize("ranks", [1, 3])
def test_keyed_reference_matches_numpy(ranks):
    sums = keyed_meanvar.KeyedSums(16, 8, CPU)
    rows = [agg.make_rows(MEANVAR, 4, r, 0, CPU) for r in range(ranks)]
    for keys, values in rows:
        keyed_meanvar.accumulate(sums, keys, values, block_rows=777)
    k, m, q = keyed_meanvar.means(sums)
    wk, wm, wq = _numpy_means(torch.cat([r[0] for r in rows]), torch.cat([r[1] for r in rows]), 16)
    assert np.array_equal(k.numpy(), wk)
    np.testing.assert_allclose(m.numpy(), wm, rtol=1e-12)
    np.testing.assert_allclose(q.numpy(), wq, rtol=1e-12)


@pytest.mark.parametrize("seed", [8, 2**31 + 13])
def test_keyed_reference_matches_the_port(seed):
    import tensorframes_tpu_torch as tft

    g = MEANVAR["keys"]
    keys, values = agg.make_rows(MEANVAR, seed, 0, 0, CPU)
    assert int(keys.min()) >= 0 and int(keys.max()) < g
    df = tft.TensorFrame([tft.Column("k", keys), tft.Column("v", values)]).repartition(4)
    m = tft.dsl.reduce_mean(tft.dsl.block(df, "v", tf_name="m_input"), axes=[0]).named("m")
    q = tft.dsl.reduce_mean(tft.dsl.square(tft.dsl.block(df, "v", tf_name="q_input")),
                            axes=[0]).named("q")
    out = tft.aggregate([m, q], tft.group_by(df, "k"), feed_dict={"m_input": "v", "q_input": "v"},
                        device="cpu")
    sums = keyed_meanvar.accumulate(keyed_meanvar.KeyedSums(g, 8, CPU), keys, values)
    wk, wm, wq = keyed_meanvar.means(sums)
    assert torch.equal(out.column("k").values, wk)
    torch.testing.assert_close(out.column("m").values.double(), wm, rtol=1e-6, atol=0)
    torch.testing.assert_close(out.column("q").values.double(), wq, rtol=1e-6, atol=0)


def test_bf16_control_is_coarser_than_float32():
    rows = [agg.make_rows(MEANVAR, 3, 0, 0, CPU)]
    sums = keyed_meanvar.accumulate(keyed_meanvar.KeyedSums(16, 8, CPU), *rows[0])
    wk, wm, _ = keyed_meanvar.means(sums)
    k, m, _ = keyed_meanvar.means_bf16(iter(rows), 16)
    assert torch.equal(k, wk)
    err = float(((m - wm).abs() / wm).max())
    assert 1e-4 < err < 0.1
