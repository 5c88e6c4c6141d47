"""PyTorch port: training (`MLP` and `TransformerLM` `loss`/`train_step`,
`models.training`), `parallel.ring.full_attention` and the parameter and
frame checkpoints of `utils.checkpoint`, held to the JAX package on the CPU.

The JAX models' parameters (made from their seeds) are carried across with
`from_jax_params`; the same seeded numpy batches go through JAX's
`value_and_grad` steps (off the TPU the JAX LM attends with
`full_attention`, the only attention JAX can differentiate) and the port's
autograd steps.

Tolerances, float32 on both sides with sums in different orders:

- losses: rtol 1e-5;
- parameters after SGD steps (the updates are lr x grad, orders of
  magnitude below the parameters): rtol 1e-5, atol 1e-6;
- parameters after Adam steps, where each update is about lr whatever the
  gradient's size, so the rounding of small gradients shows: rtol 1e-5,
  atol 1e-5 (lr 1e-3);
- `full_attention`: rtol 1e-5, atol 1e-6.

Checkpoints are exact.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.models import MLP as JMLP
from tensorframes_tpu.models import init_opt_state as jinit_opt_state
from tensorframes_tpu.models import make_train_step as jmake_train_step
from tensorframes_tpu.models.transformer import TransformerLM as JaxLM
from tensorframes_tpu.parallel.ring import full_attention as jfull_attention
from tensorframes_tpu.utils import checkpoint as jckpt
from tensorframes_tpu_torch.models import MLP, TransformerLM, init_opt_state, make_train_step
from tensorframes_tpu_torch.models.training import tree_leaves
from tensorframes_tpu_torch.ops.flash_attention import AttentionGradientError, flash_attention
from tensorframes_tpu_torch.parallel.ring import full_attention
from tensorframes_tpu_torch.utils import checkpoint as tckpt

CPU = "cpu"
_LOSS_RTOL = 1e-5
_RTOL, _ATOL = 1e-5, 1e-6
_ADAM_ATOL = 1e-5
_MLP_SIZES = [8, 16, 16, 4]
_LM_CFG = dict(vocab=32, d_model=16, n_heads=2, n_layers=2, max_seq=16, seed=0)


def _batch(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, _MLP_SIZES[0])).astype(np.float32)
    y = rng.integers(0, _MLP_SIZES[-1], n).astype(np.int32)
    return x, y


def _mlp_pair(seed=1):
    jm = JMLP(_MLP_SIZES, seed=seed)
    params = [(np.asarray(w), np.asarray(b)) for w, b in jm.params]
    return jm, jm.params, MLP.from_jax_params(params, device=CPU)


def _lm_pair():
    jm = JaxLM(**_LM_CFG)
    tm = TransformerLM.from_jax_params(
        {k: np.asarray(v) for k, v in jm.params.items()}, n_heads=_LM_CFG["n_heads"], device=CPU
    )
    return jm, jm.params, tm


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, _LM_CFG["vocab"], shape).astype(np.int32)


def _assert_params(got, want, atol=_ATOL):
    """Leaf by leaf, in JAX's flattening order."""
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=_RTOL, atol=atol)


# ---------------------------------------------------------------------------
# full_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_jax(causal):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((3, 10, 8)).astype(np.float32) for _ in range(3))
    want = np.stack([
        np.asarray(jfull_attention(q[i], k[i], v[i], causal=causal)) for i in range(3)
    ])
    got = full_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class TestMLP:
    def test_loss_matches_jax(self):
        jm, jp, tm = _mlp_pair()
        x, y = _batch()
        want = float(jm.loss(jp, jnp.asarray(x), jnp.asarray(y)))
        got = tm.loss(tm.params, torch.from_numpy(x), torch.from_numpy(y))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=_LOSS_RTOL)

    @pytest.mark.parametrize("steps", [1, 3])
    def test_train_step_matches_jax(self, steps):
        jm, jp, tm = _mlp_pair()
        x, y = _batch()
        params = tm.params
        for _ in range(steps):
            jp, jloss = jm.train_step(jp, jnp.asarray(x), jnp.asarray(y), lr=0.1)
            params, loss = tm.train_step(params, torch.from_numpy(x), torch.from_numpy(y), lr=0.1)
            np.testing.assert_allclose(float(loss), float(jloss), rtol=_LOSS_RTOL)
        # in place: the module itself holds the trained weights
        assert params[0][0] is tm.weights[0]
        _assert_params(tm.params, jp)

    def test_parameters_take_no_grad_outside_a_step(self):
        _, _, tm = _mlp_pair()
        x, y = _batch()
        tm.train_step(tm.params, torch.from_numpy(x), torch.from_numpy(y))
        assert not any(p.requires_grad for p in tm.parameters())
        assert tm(torch.from_numpy(x)).grad_fn is None

    def test_trains_on_a_column_a_verb_returned(self):
        """A verb's output is an ordinary tensor that autograd may save:
        training on it equals JAX training on the same values."""
        jm, jp, tm = _mlp_pair()
        x, y = _batch()
        df = tft.TensorFrame.from_dict({"x": x, "y": y}, num_blocks=3)
        feats = tft.map_blocks((tft.block(df, "x") * 2.0).named("h"), df, device=CPU)
        h = feats.column("h").values
        assert isinstance(h, torch.Tensor) and not h.is_inference()
        labels = torch.from_numpy(y)
        for _ in range(2):
            jp, jloss = jm.train_step(jp, jnp.asarray(x * 2.0), jnp.asarray(y), lr=0.1)
            _, loss = tm.train_step(tm.params, h, labels, lr=0.1)
            np.testing.assert_allclose(float(loss), float(jloss), rtol=_LOSS_RTOL)
        _assert_params(tm.params, jp)


# ---------------------------------------------------------------------------
# TransformerLM
# ---------------------------------------------------------------------------


class TestTransformerLM:
    def test_loss_matches_jax(self):
        jm, jp, tm = _lm_pair()
        tokens = _tokens(16)
        want = float(jm.loss(jp, jnp.asarray(tokens)))
        got = tm.loss(tm.params, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(got), want, rtol=_LOSS_RTOL)

    def test_batch_loss_is_the_mean_of_sequence_losses(self):
        jm, jp, tm = _lm_pair()
        tokens = _tokens((3, 12), seed=1)
        want = float(jnp.mean(jax.vmap(lambda t: jm.loss(jp, t))(jnp.asarray(tokens))))
        got = tm.loss(tm.params, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(got), want, rtol=_LOSS_RTOL)

    @pytest.mark.parametrize("steps", [1, 3])
    def test_train_step_matches_jax(self, steps):
        jm, jp, tm = _lm_pair()
        tokens = _tokens(16, seed=2)
        params = tm.params
        for _ in range(steps):
            jp, jloss = jm.train_step(jp, jnp.asarray(tokens), lr=0.1)
            params, loss = tm.train_step(params, torch.from_numpy(tokens), lr=0.1)
            np.testing.assert_allclose(float(loss), float(jloss), rtol=_LOSS_RTOL)
        assert params is tm.params
        _assert_params(tm.params, jp)

    def test_scoring_is_unchanged_and_builds_no_graph(self):
        _, _, tm = _lm_pair()
        tokens = torch.from_numpy(_tokens((2, 10), seed=3))
        before = tm(tokens)
        tm.train_step(tm.params, tokens, lr=0.0)
        after = tm(tokens)
        assert after.grad_fn is None and not any(p.requires_grad for p in tm.parameters())
        assert torch.equal(before, after)

    def test_flash_attention_refuses_a_gradient(self):
        q, k, v = (torch.randn(2, 8, 8, requires_grad=True) for _ in range(3))
        with pytest.raises(AttentionGradientError, match="full_attention"):
            flash_attention(q, k, v, causal=True)
        with torch.no_grad():
            assert flash_attention(q, k, v, causal=True).shape == (2, 8, 8)
        # the model's scoring forward differentiated: the same refusal
        _, _, tm = _lm_pair()
        tm.params["embed"].requires_grad_(True)
        try:
            with pytest.raises(AttentionGradientError):
                tm(torch.from_numpy(_tokens((1, 8))))
        finally:
            tm.params["embed"].requires_grad_(False)


# ---------------------------------------------------------------------------
# make_train_step against optax
# ---------------------------------------------------------------------------

_OPTIMIZERS = {
    "sgd-momentum": (
        lambda: optax.sgd(0.05, momentum=0.9),
        functools.partial(torch.optim.SGD, lr=0.05, momentum=0.9),
        _ATOL,
    ),
    "adam": (
        lambda: optax.adam(1e-3),
        functools.partial(torch.optim.Adam, lr=1e-3),
        _ADAM_ATOL,
    ),
}


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_make_train_step_mlp_matches_optax(name):
    jtx, ttx, atol = _OPTIMIZERS[name]
    jm, jp, tm = _mlp_pair()
    x, y = _batch()
    tx = jtx()
    jstep = jmake_train_step(jm.loss, tx, donate=False)
    jstate = jinit_opt_state(tx, jp)
    step = make_train_step(tm.loss, ttx)
    params, state = tm.params, init_opt_state(ttx, tm.params)
    for _ in range(4):
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(x), jnp.asarray(y))
        params, state, loss = step(params, state, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=_LOSS_RTOL)
    _assert_params(tm.params, jp, atol=atol)


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_make_train_step_lm_matches_optax(name):
    jtx, ttx, atol = _OPTIMIZERS[name]
    jm, jp, tm = _lm_pair()
    tokens = _tokens(16, seed=4)
    tx = jtx()
    jstep = jmake_train_step(jm.loss, tx, donate=False)
    jstate = jinit_opt_state(tx, jp)
    step = make_train_step(tm.loss, ttx)
    params, state = tm.params, init_opt_state(ttx, tm.params)
    for _ in range(3):
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(tokens))
        params, state, loss = step(params, state, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=_LOSS_RTOL)
    _assert_params(tm.params, jp, atol=atol)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _frame_pair():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((7, 3)).astype(np.float32)
    k = np.arange(7, dtype=np.int64)
    cells = [rng.standard_normal(n).astype(np.float32) for n in (1, 4, 2, 2, 5, 3, 1)]
    port = tft.TensorFrame(
        [tft.Column("x", torch.from_numpy(x)), tft.Column("k", k), tft.Column("r", cells)],
        offsets=[0, 2, 5, 7],
    )
    ref = tfs.TensorFrame(
        [tfs.Column("x", x), tfs.Column("k", k), tfs.Column("r", cells)], offsets=[0, 2, 5, 7]
    )
    return port, ref, (x, k, cells)


def _assert_frame(frame, x, k, cells):
    assert list(frame.offsets) == [0, 2, 5, 7]
    np.testing.assert_array_equal(np.asarray(frame.column("x").values), x)
    np.testing.assert_array_equal(np.asarray(frame.column("k").values), k)
    rows = list(frame.column("r").rows())
    assert len(rows) == len(cells)
    for a, b in zip(rows, cells):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_frame_checkpoint_round_trip(tmp_path, writer, reader):
    port, ref, want = _frame_pair()
    path = str(tmp_path / "frame.npz")
    (tckpt.save_frame if writer == "port" else jckpt.save_frame)(
        path, port if writer == "port" else ref
    )
    got = (tckpt.load_frame if reader == "port" else jckpt.load_frame)(path)
    _assert_frame(got, *want)
    if reader == "port":
        assert got.column("x").dtype is tft.schema.ScalarType.float32
        assert not got.column("r").is_dense


def test_params_round_trip_restores_the_model(tmp_path):
    _, _, tm = _lm_pair()
    tokens = torch.from_numpy(_tokens((2, 12), seed=6))
    tm.train_step(tm.params, tokens, lr=0.1)
    path = str(tmp_path / "lm.npz")
    tckpt.save_params(path, tm.params)
    fresh = TransformerLM(**{**_LM_CFG, "seed": 9}, device=CPU)
    loaded = tckpt.load_params(path, like=fresh.params)
    assert set(loaded) == set(tm.params)
    with torch.no_grad():
        for key, value in loaded.items():
            assert value.device == fresh.params[key].device
            fresh.params[key].copy_(value)
    assert torch.equal(fresh(tokens), tm(tokens))


def test_params_of_a_list_of_pairs_round_trip(tmp_path):
    _, _, tm = _mlp_pair()
    path = str(tmp_path / "mlp.npz")
    tckpt.save_params(path, tm.params)
    loaded = tckpt.load_params(path, like=tm.params)
    assert isinstance(loaded, list) and all(isinstance(p, tuple) for p in loaded)
    for (a, b), (w, c) in zip(loaded, tm.params):
        assert torch.equal(a, w) and torch.equal(b, c)
    with pytest.raises(ValueError):
        tckpt.load_params(path, like=tm.params[:1])
    with pytest.raises(ValueError):
        tckpt.load_params(path)


@pytest.fixture
def jax_npz_fallback(monkeypatch):
    """The JAX package's `save_params` as it runs where Orbax is missing:
    its npz fallback."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def test_loads_a_jax_npz_checkpoint(tmp_path, jax_npz_fallback):
    jm, jp, tm = _lm_pair()
    jp, _ = jm.train_step(jp, jnp.asarray(_tokens(16, seed=7)), lr=0.1)
    path = str(tmp_path / "jax_lm.npz")
    jckpt.save_params(path, jp)
    loaded = tckpt.load_params(path, like=tm.params)
    for key, value in jp.items():
        np.testing.assert_array_equal(loaded[key].numpy(), np.asarray(value))
    # and the JAX package reads the port's
    tpath = str(tmp_path / "port_lm.npz")
    tckpt.save_params(tpath, loaded)
    back = jckpt.load_params(tpath, like=jp)
    for key, value in jp.items():
        np.testing.assert_array_equal(np.asarray(back[key]), np.asarray(value))
