"""PyTorch port: the GPipe pipeline (`parallel.pipeline_apply`), the
expert-parallel FFN (`MoEFFN.apply_ep`), the MLP's data- and
tensor-parallel step (`param_specs`, `shard_params`,
`sharded_train_step`) and checkpoints of sharded parameters, held to the
JAX package on the CPU.

The port's meshes hold CPU slots (``torch.device("cpu")`` repeated); the
JAX package's are its 8 virtual CPU devices (`tests/conftest.py`). Inputs
and parameters are seeded numpy arrays fed to both packages.

Tolerances: the pipeline rtol 2e-5, atol 1e-6 (JAX's test against the
sequential stages) and its gradients rtol 1e-5, atol 1e-6 against
`jax.grad`; the expert FFN rtol 2e-5, atol 1e-6 (JAX's); the MLP step's
loss rtol 1e-5 and parameters rtol 1e-4 (JAX's test against the unsharded
step); shards and checkpoints exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tensorframes_tpu.models import MLP as JaxMLP
from tensorframes_tpu.models.moe import MoEFFN as JaxMoE
from tensorframes_tpu.parallel import mesh_2d as j_mesh_2d
from tensorframes_tpu.parallel.pipeline import pipeline_apply as j_pipeline
from tensorframes_tpu_torch.models import MLP, MoEFFN
from tensorframes_tpu_torch.parallel import Mesh, P, Sharded, pipeline_apply, shard
from tensorframes_tpu_torch.utils.checkpoint import load_params, save_params


def cpu_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray([torch.device("cpu")] * n, dtype=object).reshape(shape), names)


@pytest.fixture(scope="module")
def meshes():
    return JMesh(np.asarray(jax.devices()[:4]), ("stage",)), cpu_mesh((4,), ("stage",))


def _stages(n_stage, d, seed=0):
    rng = np.random.RandomState(seed)
    w = (rng.randn(n_stage, d, d) / np.sqrt(d)).astype(np.float32)
    b = (rng.randn(n_stage, d) * 0.1).astype(np.float32)
    return {"w": w, "b": b}


def _jax_stage(p, h):
    return jax.nn.relu(h @ p["w"] + p["b"])


def _torch_stage(p, h):
    return torch.relu(h @ p["w"] + p["b"])


def _torch_params(params, requires_grad=False):
    return {k: torch.from_numpy(v).requires_grad_(requires_grad) for k, v in params.items()}


class TestPipeline:
    @pytest.mark.parametrize("batch,d,micro,seed", [(16, 8, 4, 0), (6, 4, 1, 2), (12, 8, 6, 4)])
    def test_matches_jax_and_sequential(self, meshes, batch, d, micro, seed):
        jmesh, tmesh = meshes
        params = _stages(4, d, seed)
        x = np.random.RandomState(seed + 1).randn(batch, d).astype(np.float32)
        want = np.asarray(j_pipeline(
            _jax_stage, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            jmesh, num_microbatches=micro,
        ))
        got = pipeline_apply(
            _torch_stage, _torch_params(params), torch.from_numpy(x), tmesh,
            num_microbatches=micro,
        )
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6)
        h = x
        for s in range(4):
            h = np.maximum(h @ params["w"][s] + params["b"][s], 0.0)
        np.testing.assert_allclose(got.numpy(), h, rtol=2e-5, atol=1e-6)

    def test_gradients_match_jax(self, meshes):
        jmesh, tmesh = meshes
        params = _stages(4, 4, seed=3)
        x = np.random.RandomState(3).randn(8, 4).astype(np.float32)

        def jloss(p):
            return jnp.sum(j_pipeline(_jax_stage, p, jnp.asarray(x), jmesh, num_microbatches=2) ** 2)

        jg = jax.jit(jax.grad(jloss))({k: jnp.asarray(v) for k, v in params.items()})
        tp = _torch_params(params, requires_grad=True)
        out = pipeline_apply(_torch_stage, tp, torch.from_numpy(x), tmesh, num_microbatches=2)
        tg = torch.autograd.grad((out ** 2).sum(), [tp["w"], tp["b"]])
        for g, name in zip(tg, ("w", "b")):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]), rtol=1e-5, atol=1e-6,
                                       err_msg=name)

    def test_bad_microbatch_count(self, meshes):
        jmesh, tmesh = meshes
        params = _stages(4, 4)
        x = np.zeros((10, 4), np.float32)
        with pytest.raises(ValueError, match="microbatches"):
            j_pipeline(_jax_stage, params, jnp.asarray(x), jmesh, num_microbatches=3)
        with pytest.raises(ValueError, match="microbatches"):
            pipeline_apply(_torch_stage, _torch_params(params), torch.from_numpy(x), tmesh,
                           num_microbatches=3)

    def test_stage_axis_must_match_the_mesh(self, meshes):
        _, tmesh = meshes
        with pytest.raises(ValueError, match="leading axis"):
            pipeline_apply(_torch_stage, _torch_params(_stages(3, 4)), torch.zeros(4, 4), tmesh,
                           num_microbatches=2)


class TestMoE:
    @pytest.mark.parametrize("n_shard,tokens", [(8, 24), (4, 16), (2, 7)])
    def test_ep_matches_jax(self, n_shard, tokens):
        jm = JaxMoE(d_model=16, d_hidden=32, num_experts=8, top_k=2, seed=0)
        params = {k: np.asarray(v) for k, v in jm.params.items()}
        tm = MoEFFN.from_jax_params(params, top_k=2, device="cpu")
        x = np.random.RandomState(0).randn(tokens, 16).astype(np.float32)
        jmesh = JMesh(np.asarray(jax.devices()[:n_shard]), ("model",))
        want = np.asarray(jm.apply_ep(jm.params, jnp.asarray(x), jmesh, axis="model"))
        tmesh = cpu_mesh((n_shard,), ("model",))
        got = tm.apply_ep(tm.params, torch.from_numpy(x), tmesh)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6)
        dense = tm.apply(tm.params, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-5, atol=1e-6)
        # experts laid out once ahead of the call are used as they are
        pre = dict(tm.params)
        pre["w1"] = shard(tm.params["w1"], tmesh, P("model"))
        pre["w2"] = shard(tm.params["w2"], tmesh, P("model"))
        assert torch.equal(tm.apply_ep(pre, torch.from_numpy(x), tmesh), got)

    def test_ep_on_one_axis_of_a_2d_mesh(self):
        tm = MoEFFN(d_model=8, d_hidden=16, num_experts=4, top_k=2, seed=1, device="cpu")
        x = torch.from_numpy(np.random.RandomState(1).randn(10, 8).astype(np.float32))
        got = tm.apply_ep(tm.params, x, cpu_mesh((2, 4), ("data", "model")))
        np.testing.assert_allclose(got.numpy(), tm(x).numpy(), rtol=2e-5, atol=1e-6)

    def test_indivisible_experts_rejected(self):
        x = np.zeros((4, 32), np.float32)
        jm = JaxMoE(num_experts=8)
        with pytest.raises(ValueError, match="divide"):
            jm.apply_ep(jm.params, jnp.asarray(x), JMesh(np.asarray(jax.devices()[:3]), ("model",)))
        tm = MoEFFN(num_experts=8, device="cpu")
        with pytest.raises(ValueError, match="divide"):
            tm.apply_ep(tm.params, torch.from_numpy(x), cpu_mesh((3,), ("model",)))


def _mlp_pair(sizes, seed=0):
    jm = JaxMLP(sizes, seed=seed)
    params = [(np.asarray(w, np.float32), np.asarray(b, np.float32)) for w, b in jm.params]
    return jm, params, MLP.from_jax_params(params, device="cpu")


class TestMLPShardedStep:
    def test_param_specs_are_jax_specs(self):
        jm, _, tm = _mlp_pair([8, 16, 16, 4])
        assert [tuple(map(tuple, s)) for s in tm.param_specs()] == [
            tuple(map(tuple, s)) for s in jm.param_specs()]

    def test_shards_match_jax(self):
        jm, params, tm = _mlp_pair([8, 16, 4])
        jparams = jm.shard_params([(jnp.asarray(w), jnp.asarray(b)) for w, b in params],
                                  j_mesh_2d(4, 2))
        tmesh = cpu_mesh((4, 2), ("data", "model"))
        sharded = tm.shard_params(tm.params, tmesh)
        jorder = list(j_mesh_2d(4, 2).devices.flat)
        for (jw, jb), (w, b) in zip(jparams, sharded):
            for jt, t in ((jw, w), (jb, b)):
                assert isinstance(t, Sharded)
                for s in jt.addressable_shards:
                    coord = np.unravel_index(jorder.index(s.device), (4, 2))
                    np.testing.assert_array_equal(t.shards[coord].numpy(), np.asarray(s.data))

    @pytest.mark.parametrize("sizes,mesh_shape", [([8, 16, 4], (4, 2)), ([8, 16, 4], (2, 2)),
                                                  ([8, 16, 16, 4], (2, 2)), ([6, 8, 8, 8, 4], (1, 4))])
    def test_step_matches_jax_and_the_unsharded_step(self, sizes, mesh_shape):
        jm, params, tm = _mlp_pair(sizes)
        jmesh = j_mesh_2d(*mesh_shape)
        rng = np.random.RandomState(0)
        x = rng.rand(16, sizes[0]).astype(np.float32)
        y = rng.randint(0, sizes[-1], 16)
        jparams = jm.shard_params([(jnp.asarray(w), jnp.asarray(b)) for w, b in params], jmesh)
        jnew, jloss = jm.sharded_train_step(jmesh, lr=0.05)(jparams, jnp.asarray(x), jnp.asarray(y))
        tmesh = cpu_mesh(mesh_shape, ("data", "model"))
        step = tm.sharded_train_step(tmesh, lr=0.05)
        new, loss = step(tm.shard_params(tm.params, tmesh), torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        ref = [(w.detach().clone(), b.detach().clone()) for w, b in tm.params]
        _, rloss = tm.train_step(ref, torch.from_numpy(x), torch.from_numpy(y), lr=0.05)
        np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
        for (w, b), (jw, jb), (rw, rb) in zip(new, jnew, ref):
            for t, jt, rt in ((w, jw, rw), (b, jb, rb)):
                np.testing.assert_allclose(t.gather().numpy(), np.asarray(jt), rtol=1e-4, atol=1e-7)
                np.testing.assert_allclose(t.gather().numpy(), rt.numpy(), rtol=1e-4, atol=1e-7)

    def test_step_takes_global_parameters(self):
        _, _, tm = _mlp_pair([8, 16, 4], seed=2)
        tmesh = cpu_mesh((2, 2), ("data", "model"))
        x = torch.rand(8, 8, generator=torch.Generator().manual_seed(0))
        y = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3])
        step = tm.sharded_train_step(tmesh, lr=0.1)
        a, la = step(tm.params, x, y)
        b, lb = step(tm.shard_params(tm.params, tmesh), x, y)
        assert float(la) == float(lb)
        for (wa, ba), (wb, bb) in zip(a, b):
            assert torch.equal(wa.gather(), wb.gather()) and torch.equal(ba.gather(), bb.gather())


def test_sharded_training_resumes_identically(tmp_path):
    """The counterpart of `tests/test_aux.py`'s resume test: a sharded MLP
    step saved, reloaded with ``like=`` (onto its mesh and specs) and
    resumed gives the same parameters and loss, bit for bit."""
    _, _, model = _mlp_pair([8, 16, 4], seed=1)
    mesh = cpu_mesh((2, 2), ("data", "model"))
    step = model.sharded_train_step(mesh, lr=0.1)
    params = model.shard_params(model.params, mesh)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(8, 8).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 4, 8))

    params, _ = step(params, x, y)
    path = str(tmp_path / "mid.npz")
    save_params(path, params)
    cont, loss_a = step(params, x, y)

    resumed = load_params(path, like=params)
    for (w, b), (rw, rb) in zip(params, resumed):
        for t, r in ((w, rw), (b, rb)):
            assert isinstance(r, Sharded) and r.spec == t.spec and r.mesh == t.mesh
            assert all(torch.equal(r.shards[c], t.shards[c]) for c in np.ndindex(2, 2))
    resumed, loss_b = step(resumed, x, y)
    assert float(loss_a) == float(loss_b)
    for (w, b), (rw, rb) in zip(cont, resumed):
        assert torch.equal(w.gather(), rw.gather()) and torch.equal(b.gather(), rb.gather())
