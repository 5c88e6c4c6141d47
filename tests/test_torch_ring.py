"""PyTorch port: ring attention, the Ulysses all-to-all, the lockstep
collectives, sharded tensors, `TransformerLM`'s mesh paths and its 3-D
step, held to the JAX package on the CPU.

The port's meshes hold CPU slots (``torch.device("cpu")`` repeated), the
stand-in for the JAX package's 8 virtual CPU devices (`tests/conftest.py`);
both sides split the sequence, the batch and the heads into the same
shards. Inputs are seeded numpy arrays fed to both packages. On CPU slots
`ring_attention` runs JAX's plain `_online_step`; the kernel route's
control flow and its log-sum-exp merge run here too, with the kernel's
plain version (`flash_attention_lse_reference`) in each step, and
`chip_smoke.py` runs it with the kernel on the card.

Tolerances: ring outputs rtol 1e-5, atol 1e-6 against JAX's ring (the
same float32 online softmax; products round in another order); ring
gradients rtol 1e-4, atol 1e-5 against `jax.grad` (a backward through
eight steps); LM logits and losses rtol 1e-4, atol 1e-5 (four float32
layers); the 3-D step's loss rtol 1e-5 and every parameter rtol 2e-4,
atol 2e-6 (JAX's own test against the single-device step); the
all-to-all and the layout views exact (they move values).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tensorframes_tpu.models import TransformerLM as JaxLM
from tensorframes_tpu.parallel import data_mesh as j_data_mesh
from tensorframes_tpu.parallel.ring import full_attention as j_full
from tensorframes_tpu.parallel.ring import ring_attention as j_ring
from tensorframes_tpu.parallel.ring import seq_all_to_all as j_a2a
from tensorframes_tpu_torch.models import TransformerLM
from tensorframes_tpu_torch.ops.flash_attention import (
    AttentionGradientError,
    flash_attention_lse,
    flash_attention_lse_reference,
    flash_attention_reference,
)
from tensorframes_tpu_torch.parallel import (
    Mesh,
    P,
    Sharded,
    collectives,
    full_attention,
    ring_attention,
    ring_attention_reference,
    seq_all_to_all,
    shard,
)
from tensorframes_tpu_torch.parallel.ring import _merge, _ring
from tensorframes_tpu_torch.parallel.sharding import as_sharded

_RTOL, _ATOL = 1e-5, 1e-6
_GRAD_RTOL, _GRAD_ATOL = 1e-4, 1e-5
_LM_RTOL, _LM_ATOL = 1e-4, 1e-5
_STEP_RTOL, _STEP_ATOL = 2e-4, 2e-6


def cpu_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray([torch.device("cpu")] * n, dtype=object).reshape(shape), names)


@pytest.fixture(scope="module")
def jmesh():
    return j_data_mesh()


@pytest.fixture(scope="module")
def tmesh():
    return cpu_mesh((8,), ("data",))


def _arrays(shape, n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _jax_ring(q, k, v, jmesh, causal):
    """JAX's ring over the trailing (S, d) axes, vmapped over the rest."""
    fn = lambda a, b, c: j_ring(a, b, c, jmesh, causal=causal)  # noqa: E731
    for _ in range(q.ndim - 2):
        fn = jax.vmap(fn)
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("shape,seed", [((64, 16), 0), ((64, 8), 1), ((64, 15), 2)])
    def test_single_head_matches_jax(self, jmesh, tmesh, causal, shape, seed):
        q, k, v = _arrays(shape, seed=seed)
        want = _jax_ring(q, k, v, jmesh, causal)
        got = ring_attention(*map(torch.from_numpy, (q, k, v)), tmesh, causal=causal)
        assert got.shape == shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=_RTOL, atol=_ATOL)
        full = np.asarray(j_full(*map(jnp.asarray, (q, k, v)), causal=causal))
        np.testing.assert_allclose(got.numpy(), full, rtol=2e-5, atol=2e-6)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("lead", [(4,), (2, 3)])
    def test_batched_heads_match_jax(self, jmesh, tmesh, causal, lead):
        q, k, v = _arrays(lead + (128, 8), seed=3)
        want = _jax_ring(q, k, v, jmesh, causal)
        got = ring_attention(*map(torch.from_numpy, (q, k, v)), tmesh, causal=causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=_RTOL, atol=_ATOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_reference_is_the_same_ring(self, tmesh, causal):
        q, k, v = map(torch.from_numpy, _arrays((3, 64, 8), seed=4))
        assert torch.equal(
            ring_attention(q, k, v, tmesh, causal=causal),
            ring_attention_reference(q, k, v, tmesh, causal=causal),
        )

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("n", [1, 2, 4, 8])
    def test_kernel_route_merges_like_the_plain_steps(self, monkeypatch, causal, n):
        """The route CUDA shards take, one `flash_attention_lse` a step
        merged by log-sum-exp, with the kernel's plain version in the steps
        (what the wrapper runs for CPU tensors): it skips the later blocks
        of a causal ring, builds no mask tensor, and agrees with the plain
        steps and with JAX's full attention."""
        q, k, v = _arrays((4, 64, 16), seed=5)
        split = [torch.chunk(torch.from_numpy(t), n, dim=-2) for t in (q, k, v)]
        scale = 1.0 / math.sqrt(16)
        steps = []
        real = flash_attention_lse

        def counted(*a, **kw):
            steps.append(kw["causal"])
            return real(*a, **kw)

        monkeypatch.setattr("tensorframes_tpu_torch.parallel.ring.flash_attention_lse", counted)
        with monkeypatch.context() as m:
            # the kernel masks the diagonal itself: no (Sq, Sk) mask is built
            m.setattr("tensorframes_tpu_torch.parallel.ring._step_mask", None)
            out = _ring(*[list(s) for s in split], causal=causal, scale=scale, kernel=True)
        plain = _ring(*[list(s) for s in split], causal=causal, scale=scale, kernel=False)
        got = torch.cat(out, dim=-2).numpy()
        np.testing.assert_allclose(got, torch.cat(plain, dim=-2).numpy(), rtol=_RTOL, atol=_ATOL)
        full = jax.vmap(lambda a, b, c: j_full(a, b, c, causal=causal))(
            *map(jnp.asarray, (q, k, v)))
        np.testing.assert_allclose(got, np.asarray(full), rtol=_RTOL, atol=_ATOL)
        assert len(steps) == (n * (n + 1) // 2 if causal else n * n)
        assert sum(steps) == (n if causal else 0)  # the diagonal steps are causal

    @pytest.mark.parametrize("causal", [False, True])
    def test_kernel_route_at_head_dim_15(self, monkeypatch, jmesh, causal):
        """The kernel route at a head width the kernel takes only through
        the wrapper's layout step (zero-padded to 16): each step's
        `flash_attention_lse` is what a CUDA shard goes through, the layout
        step and its restore around the plain version, and the ring agrees
        with JAX's ring and full attention."""
        from tensorframes_tpu_torch.ops import flash_attention as fa

        def routed(q, k, v, *, causal, scale):
            q3, k3, v3, sc, restore = fa._kernel_layout(q, k, v, scale)
            assert q3.shape[-1] == 16
            return restore(*flash_attention_lse_reference(q3, k3, v3, causal=causal, scale=sc))

        q, k, v = _arrays((4, 64, 15), seed=6)
        n = 4
        split = [list(torch.chunk(torch.from_numpy(t), n, dim=-2)) for t in (q, k, v)]
        monkeypatch.setattr("tensorframes_tpu_torch.parallel.ring.flash_attention_lse", routed)
        out = _ring(*split, causal=causal, scale=1.0 / math.sqrt(15), kernel=True)
        got = torch.cat(out, dim=-2).numpy()
        assert got.shape == (4, 64, 15)
        np.testing.assert_allclose(got, _jax_ring(q, k, v, jmesh, causal),
                                   rtol=_RTOL, atol=_ATOL)
        full = jax.vmap(lambda a, b, c: j_full(a, b, c, causal=causal))(
            *map(jnp.asarray, (q, k, v)))
        np.testing.assert_allclose(got, np.asarray(full), rtol=_RTOL, atol=_ATOL)

    def test_merge_weighs_a_masked_step_zero(self):
        o = torch.ones(2, 3, 4)
        m = torch.tensor([[0.5, -math.inf, 1.0], [0.0, 0.0, 0.0]])
        state = (torch.full((2, 3), -math.inf), torch.zeros(2, 3), torch.zeros(2, 3, 4))
        state = _merge(*state, o, m)
        state = _merge(*state, 7 * o, torch.full((2, 3), -math.inf))
        _, l, acc = state
        assert torch.isfinite(acc).all() and torch.isfinite(l).all()
        assert torch.equal(l, torch.tensor([[1.0, 0.0, 1.0], [1.0, 1.0, 1.0]]))
        assert torch.equal(acc[0, 1], torch.zeros(4)) and torch.equal(acc[0, 0], torch.ones(4))

    @pytest.mark.parametrize("causal", [False, True])
    def test_reference_gradients_match_jax(self, jmesh, tmesh, causal):
        q, k, v = _arrays((32, 8), seed=2)
        jg = jax.jit(jax.grad(
            lambda a, b, c: jnp.sum(j_ring(a, b, c, jmesh, causal=causal) ** 2), argnums=(0, 1, 2)
        ))(*map(jnp.asarray, (q, k, v)))
        ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
        out = ring_attention_reference(*ts, tmesh, causal=causal)
        tg = torch.autograd.grad((out ** 2).sum(), ts)
        for g, want in zip(tg, jg):
            np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=_GRAD_RTOL, atol=_GRAD_ATOL)

    def test_refuses_a_gradient(self, tmesh):
        q = torch.zeros(16, 8, requires_grad=True)
        with pytest.raises(AttentionGradientError, match="ring_attention_reference"):
            ring_attention(q, q, q, tmesh)
        with torch.no_grad():
            assert ring_attention(q, q, q, tmesh).shape == (16, 8)

    def test_indivisible_sequence_rejected(self, jmesh, tmesh):
        x = np.zeros((10, 8), np.float32)
        with pytest.raises(ValueError, match="divisible"):
            j_ring(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), jmesh)
        t = torch.from_numpy(x)
        for fn in (ring_attention, ring_attention_reference):
            with pytest.raises(ValueError, match="divisible"):
                fn(t, t, t, tmesh)

    def test_ring_over_one_axis_of_a_3d_mesh(self):
        """The ring takes its axis of a larger mesh (the other axes replicate,
        as under JAX's shard_map), with its shards on that axis's slots."""
        mesh = cpu_mesh((2, 4, 1), ("data", "seq", "model"))
        assert [c for c in collectives.axis_groups(mesh, "seq")[1]] == [(1, s, 0) for s in range(4)]
        q, k, v = map(torch.from_numpy, _arrays((2, 32, 8), seed=6))
        got = ring_attention(q, k, v, mesh, axis="seq", causal=True)
        np.testing.assert_allclose(
            got.numpy(), full_attention(q, k, v, causal=True).numpy(), rtol=_RTOL, atol=_ATOL
        )


class TestFlashAttentionLse:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("scale", [None, -0.125, 0.0])
    def test_reference_against_float64(self, causal, scale):
        q, k, v = map(torch.from_numpy, _arrays((3, 40, 8), seed=7))
        out, lse = flash_attention_lse_reference(q, k, v, causal=causal, scale=scale)
        assert lse.shape == (3, 40) and lse.dtype == torch.float32
        assert torch.equal(out, flash_attention_reference(q, k, v, causal=causal, scale=scale))
        sc = 1.0 / math.sqrt(8) if scale is None else scale
        s64 = torch.matmul(q.double(), k.double().transpose(-1, -2)) * sc
        if causal:
            s64 = s64.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(), -math.inf)
        want = torch.logsumexp(s64, dim=-1)
        np.testing.assert_allclose(lse.double().numpy(), want.numpy(), rtol=1e-6, atol=1e-6)

    def test_wrapper_takes_the_plain_version_on_the_cpu(self):
        q, k, v = map(torch.from_numpy, _arrays((2, 64, 16), seed=8))
        got = flash_attention_lse(q, k, v, causal=True)
        want = flash_attention_lse_reference(q, k, v, causal=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))

    def test_refuses_a_gradient(self):
        q = torch.zeros(1, 8, 8, requires_grad=True)
        with pytest.raises(AttentionGradientError):
            flash_attention_lse(q, q, q)


class TestSeqAllToAll:
    def test_each_shard_matches_jax(self, jmesh, tmesh):
        x = np.random.RandomState(0).randn(16, 8, 4).astype(np.float32)  # (seq, heads, d)
        jy = j_a2a(jnp.asarray(x), jmesh, seq_axis=0, head_axis=1)
        y = seq_all_to_all(torch.from_numpy(x), tmesh, seq_axis=0, head_axis=1)
        assert isinstance(y, Sharded) and y.spec == P(None, "data", None)
        order = list(jmesh.devices.flat)
        for js in jy.addressable_shards:
            i = order.index(js.device)
            got = y.shards[(i,)]
            assert got.device == tmesh.devices[(i,)] and tuple(got.shape) == (16, 1, 4)
            np.testing.assert_array_equal(got.numpy(), np.asarray(js.data))
            np.testing.assert_array_equal(got.numpy(), x[:, i:i + 1])
        assert torch.equal(y.gather(), torch.from_numpy(x))

    def test_round_trip(self, tmesh):
        x = torch.from_numpy(np.random.RandomState(1).randn(16, 8, 4).astype(np.float32))
        y = seq_all_to_all(x, tmesh, seq_axis=0, head_axis=1)
        back = seq_all_to_all(y, tmesh, seq_axis=1, head_axis=0)
        assert back.spec == P("data", None, None)
        for i in range(8):
            assert torch.equal(back.shards[(i,)], x[2 * i:2 * i + 2])
        assert torch.equal(back.gather(), x)

    def test_indivisible_rejected(self, jmesh, tmesh):
        x = np.zeros((10, 8, 4), np.float32)
        with pytest.raises(ValueError, match="divide"):
            j_a2a(jnp.asarray(x), jmesh, seq_axis=0, head_axis=1)
        with pytest.raises(ValueError, match="divide"):
            seq_all_to_all(torch.from_numpy(x), tmesh, seq_axis=0, head_axis=1)


class TestCollectivesAndSharding:
    def test_lockstep_collectives(self):
        devs = [torch.device("cpu")] * 3
        xs = [torch.full((2,), float(i)) for i in range(3)]
        assert [t.tolist() for t in collectives.psum(xs)] == [[3.0, 3.0]] * 3
        assert [t.tolist() for t in collectives.pmax(xs)] == [[2.0, 2.0]] * 3
        moved = collectives.ppermute(xs, [(0, 1), (1, 2)], devs)
        assert moved[0] is None and moved[1].tolist() == [0.0, 0.0] and moved[2].tolist() == [1.0, 1.0]
        blocks = [torch.arange(6.0).reshape(3, 2) + 10 * i for i in range(3)]
        out = collectives.all_to_all(blocks, split_axis=0, concat_axis=1)
        assert torch.equal(out[1], torch.cat([b[1:2] for b in blocks], dim=1))

    def test_gradients_are_jax_transposes(self):
        """A tensor copied to every shard gets its gradients summed; the
        gradient of a psum is a psum, that of a ppermute its inverse."""
        w = torch.tensor([1.0, 2.0], requires_grad=True)
        xs = [w * (i + 1) for i in range(3)]
        sums = collectives.psum(xs)
        (g,) = torch.autograd.grad(sum(s.sum() for s in sums), [w])
        assert g.tolist() == [18.0, 18.0]  # 3 copies x (1 + 2 + 3)
        ys = [w * (i + 1) for i in range(3)]
        moved = collectives.ppermute(ys, [(0, 1), (1, 2), (2, 0)], [torch.device("cpu")] * 3)
        (g,) = torch.autograd.grad(moved[1].sum(), [w])
        assert g.tolist() == [1.0, 1.0]  # shard 1 holds shard 0's w * 1

    def test_axis_groups(self):
        mesh = cpu_mesh((2, 2, 2), ("data", "seq", "model"))
        assert collectives.axis_groups(mesh, "model") == [
            [(0, 0, 0), (0, 0, 1)], [(0, 1, 0), (0, 1, 1)],
            [(1, 0, 0), (1, 0, 1)], [(1, 1, 0), (1, 1, 1)],
        ]
        assert collectives.axis_groups(mesh, ("data", "seq")) == [
            [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)],
            [(0, 0, 1), (0, 1, 1), (1, 0, 1), (1, 1, 1)],
        ]
        with pytest.raises(ValueError, match="no axis"):
            collectives.axis_groups(mesh, "stage")

    @pytest.mark.parametrize("spec", [P(), P("data"), P(None, "model"), P(("data", "model"), None),
                                      P("model", "data")])
    def test_shard_gather_round_trip(self, spec):
        mesh = cpu_mesh((2, 2), ("data", "model"))
        t = torch.arange(48.0).reshape(8, 6)
        sh = shard(t, mesh, spec)
        assert torch.equal(sh.gather(), t)
        for c in np.ndindex(2, 2):
            assert torch.equal(sh.shards[c], t[sh.block_slices(c)])
        assert as_sharded(sh, mesh, spec) is sh
        assert torch.equal(as_sharded(sh, mesh, P(None, "data")).gather(), t)

    def test_indivisible_shard_rejected(self):
        with pytest.raises(ValueError, match="divisible"):
            shard(torch.zeros(5, 2), cpu_mesh((2,), ("data",)), P("data"))


# --------------------------------------------------------------------------
# TransformerLM over meshes
# --------------------------------------------------------------------------

_CFG = dict(vocab=32, d_model=16, n_heads=2, n_layers=2, max_seq=64, seed=0)


@pytest.fixture(scope="module")
def lms():
    jm = JaxLM(**_CFG)
    params = {k: np.asarray(v) for k, v in jm.params.items()}
    return jm, TransformerLM.from_jax_params(params, n_heads=_CFG["n_heads"], device="cpu")


def _tokens(b, s, seed=0, vocab=32):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


class TestTransformerMesh:
    def test_apply_with_mesh_matches_jax(self, lms, jmesh, tmesh):
        jm, tm = lms
        tokens = _tokens(2, 32)
        japply = jax.jit(lambda p, t: jm.apply(p, t, jmesh))
        want = np.stack([np.asarray(japply(jm.params, jnp.asarray(t))) for t in tokens])
        got = tm.apply(tm.params, torch.from_numpy(tokens), mesh=tmesh)
        np.testing.assert_allclose(got.numpy(), want, rtol=_LM_RTOL, atol=_LM_ATOL)
        alone = tm(torch.from_numpy(tokens))
        np.testing.assert_allclose(got.numpy(), alone.numpy(), rtol=_LM_RTOL, atol=_LM_ATOL)
        assert torch.equal(tm(torch.from_numpy(tokens), mesh=tmesh), got)

    def test_loss_and_train_step_with_mesh_match_jax(self, lms, jmesh, tmesh):
        jm, _ = lms
        tokens = _tokens(1, 33, seed=1)[0]
        jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, t: jm.loss(p, t, jmesh)))(
            jm.params, jnp.asarray(tokens))
        tm = TransformerLM.from_jax_params(
            {k: np.asarray(v) for k, v in jm.params.items()}, n_heads=2, device="cpu")
        t = torch.from_numpy(tokens)
        loss = tm.loss(tm.params, t, mesh=tmesh)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=_LM_RTOL)
        _, step_loss = tm.train_step(tm.params, t, lr=0.1, mesh=tmesh)
        assert float(step_loss) == float(loss)
        for name, g in jgrads.items():
            want = np.asarray(jm.params[name]) - 0.1 * np.asarray(g)
            np.testing.assert_allclose(
                tm.params[name].detach().numpy(), want, rtol=_STEP_RTOL, atol=_STEP_ATOL,
                err_msg=name,
            )

    def test_attention_and_mesh_together_rejected(self, lms, tmesh):
        _, tm = lms
        with pytest.raises(ValueError, match="not both"):
            tm(torch.zeros(1, 8, dtype=torch.int32), attention=full_attention, mesh=tmesh)


def _mesh3d_pair():
    jm = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2), ("data", "seq", "model"))
    return jm, cpu_mesh((2, 2, 2), ("data", "seq", "model"))


def _assert_layout(got, want, rtol=_STEP_RTOL, atol=_STEP_ATOL):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(
            np.asarray(got[name]), np.asarray(want[name]), rtol=rtol, atol=atol, err_msg=name
        )


class Test3DShardedTrainStep:
    def _pair(self, **cfg):
        jm = JaxLM(**cfg)
        params = {k: np.asarray(v) for k, v in jm.params.items()}
        return jm, TransformerLM.from_jax_params(params, n_heads=cfg["n_heads"], device="cpu")

    @pytest.mark.parametrize("shape", [(2, 2, 2), (1, 4, 2), (2, 1, 4)])
    def test_matches_jax_step_every_parameter(self, shape):
        jm, tm = self._pair(vocab=16, d_model=8, n_heads=4, n_layers=2, max_seq=32, seed=3)
        jmesh = JMesh(np.asarray(jax.devices()[:8]).reshape(shape), ("data", "seq", "model"))
        tmesh = cpu_mesh(shape, ("data", "seq", "model"))
        toks = _tokens(4, 16, seed=0, vocab=16)
        jlayout, jloss = jm.sharded_train_step_3d(jmesh, lr=0.1)(
            jm.device_layout(jm.params), jnp.asarray(toks))
        layout, loss = tm.sharded_train_step_3d(tmesh, lr=0.1)(
            tm.device_layout(tm.params), torch.from_numpy(toks))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        want = {k: np.asarray(v) for k, v in jm.merge_layout(jlayout).items()}
        _assert_layout({k: v.numpy() for k, v in tm.merge_layout(layout).items()}, want)
        # every shard sits on its slot with its spec's block
        for kind in ("rep", "shd"):
            for key, sh in layout[kind].items():
                assert isinstance(sh, Sharded) and sh.spec == tm._layout_specs()[kind][key]

    def test_matches_the_single_device_step(self):
        _, tm = self._pair(vocab=16, d_model=8, n_heads=2, n_layers=2, max_seq=32, seed=3)
        _, tmesh = _mesh3d_pair()
        toks = torch.from_numpy(_tokens(2, 8, vocab=16))
        layout, loss = tm.sharded_train_step_3d(tmesh, lr=0.1)(tm.device_layout(tm.params), toks)
        ref = {k: v.detach().clone() for k, v in tm.params.items()}
        _, rloss = tm.train_step(ref, toks, lr=0.1)
        np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
        _assert_layout({k: v.numpy() for k, v in tm.merge_layout(layout).items()},
                       {k: v.numpy() for k, v in ref.items()})

    def test_second_step_decreases_loss(self):
        _, tm = self._pair(vocab=16, d_model=8, n_heads=2, n_layers=1, max_seq=1024, seed=0)
        _, tmesh = _mesh3d_pair()
        step = tm.sharded_train_step_3d(tmesh, lr=0.3)
        toks = torch.from_numpy(_tokens(4, 8, seed=1, vocab=16))
        layout, l0 = step(tm.device_layout(tm.params), toks)
        layout, l1 = step(layout, toks)
        assert float(l1) < float(l0)

    def test_indivisible_heads_or_vocab_rejected(self):
        jmesh, tmesh = _mesh3d_pair()
        cfg = dict(vocab=15, d_model=8, n_heads=2, n_layers=1)
        with pytest.raises(ValueError, match="must divide"):
            JaxLM(**cfg).sharded_train_step_3d(jmesh)
        with pytest.raises(ValueError, match="must divide"):
            TransformerLM(**cfg, device="cpu").sharded_train_step_3d(tmesh)

    def test_over_long_sequence_rejected(self):
        jmesh, tmesh = _mesh3d_pair()
        cfg = dict(vocab=16, d_model=8, n_heads=2, n_layers=1, max_seq=8)
        jm = JaxLM(**cfg)
        with pytest.raises(ValueError, match="exceeds max_seq"):
            jm.sharded_train_step_3d(jmesh)(jm.device_layout(jm.params), jnp.zeros((2, 32), jnp.int32))
        tm = TransformerLM(**cfg, device="cpu")
        with pytest.raises(ValueError, match="exceeds max_seq"):
            tm.sharded_train_step_3d(tmesh)(tm.device_layout(tm.params), torch.zeros(2, 32, dtype=torch.int32))

    def test_indivisible_tokens_rejected(self):
        _, tmesh = _mesh3d_pair()
        tm = TransformerLM(vocab=16, d_model=8, n_heads=2, n_layers=1, device="cpu")
        with pytest.raises(ValueError, match="divisible"):
            tm.sharded_train_step_3d(tmesh)(tm.device_layout(tm.params), torch.zeros(3, 8, dtype=torch.int32))

    def test_layout_round_trip_and_from_jax_params(self):
        jm, tm = self._pair(vocab=16, d_model=8, n_heads=2, n_layers=2, max_seq=32, seed=4)
        jl = jm.device_layout(jm.params)
        tl = tm.device_layout(tm.params)
        for kind in ("rep", "shd"):
            assert set(tl[kind]) == set(jl[kind])
            for key in jl[kind]:
                # the JAX model's parameters are float64 under its x64 mode;
                # from_jax_params keeps them as float32
                np.testing.assert_array_equal(
                    tl[kind][key].numpy(), np.asarray(jl[kind][key], np.float32))
        back = tm.merge_layout(tl)
        assert set(back) == set(tm.params)
        for k in back:
            assert torch.equal(back[k], tm.params[k])
        jspecs = jm._layout_specs()
        for kind, specs in tm._layout_specs().items():
            assert {k: tuple(v) for k, v in specs.items()} == {
                k: tuple(v) for k, v in jspecs[kind].items()}
