"""PyTorch port: `models.MLP`, `models.kmeans` and `models.InceptionLite`
held to the JAX models on the CPU, and the frozen Keras Inception-v3 graph
scored by both packages.

Tolerances:
- MLP logits and softmax scores (float32 products, TF32 off): rtol 1e-5,
  atol 1e-6, because the two frameworks sum the products in different
  orders;
- k-means: the same seed draws the same initial centres; the counts are
  exact and the centres within rtol 1e-5, atol 1e-6 (float32 sums of the
  assigned points in a different order);
- InceptionLite and the frozen Keras Inception-v3 probabilities: rtol 1e-4,
  atol 1e-6 (float32 convolutions summed in another order by XLA's and
  ATen's CPU kernels, through dozens of layers), and the same top-1.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
import torch
from tensorframes_tpu.graph import builder as jdsl
from tensorframes_tpu.models import InceptionLite as JInceptionLite
from tensorframes_tpu.models import MLP as JMLP
from tensorframes_tpu.models.kmeans import kmeans as j_kmeans
from tensorframes_tpu_torch.models import MLP, InceptionLite, kmeans

CPU = "cpu"


def _jax_params(model):
    return [(np.asarray(w), np.asarray(b)) for w, b in model.params]


class TestMLP:
    def test_from_jax_params_forward_matches_apply(self):
        jm = JMLP([16, 32, 32, 5], seed=3)
        x = np.random.default_rng(0).standard_normal((40, 16)).astype(np.float32)
        ref = np.asarray(jm.apply(jm.params, x))
        got = MLP.from_jax_params(_jax_params(jm), device=CPU)(torch.from_numpy(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("block", [True, False])
    def test_scoring_graph_is_the_reference_graph(self, block):
        jm = JMLP([6, 8, 3], seed=1)
        tm = MLP.from_jax_params(_jax_params(jm), device=CPU)
        jg, jf = jdsl.build(jm.scoring_graph("features", block=block))
        tg, tf_ = tft.dsl.build(tm.scoring_graph("features", block=block))
        assert tf_ == jf
        assert tg.to_bytes() == jg.to_bytes()

    def test_scoring_routes_agree_with_the_reference(self):
        """The per-row graph through map_rows, and the same weights through
        the function front end, against the JAX package's map_rows."""
        jm = JMLP([12, 20, 4], seed=2)
        tm = MLP.from_jax_params(_jax_params(jm), device=CPU)
        data = {"features": np.random.default_rng(1).standard_normal((33, 12)).astype(np.float32)}
        jdf = tfs.TensorFrame.from_dict(data, num_blocks=3)
        tdf = tft.TensorFrame.from_dict(data, num_blocks=3)
        ref = np.asarray(tfs.map_rows(jm.scoring_graph(block=False), jdf).host_values("probs"))
        graph = tft.map_rows(tm.scoring_graph(block=False), tdf, device=CPU).host_values("probs")
        ws = {f"w{i}": w for i, (w, _) in enumerate(_jax_params(jm))}
        bs = {f"b{i}": b for i, (_, b) in enumerate(_jax_params(jm))}

        def score(features, w0, b0, w1, b1):
            h = torch.relu(features @ w0 + b0)
            return {"probs": torch.softmax(h @ w1 + b1, dim=-1)}

        fn = tft.map_rows(score, tdf, bindings={**ws, **bs}, device=CPU).host_values("probs")
        for got in (graph, fn):
            assert got.shape == (33, 4) and got.dtype == np.float32
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    def test_own_init_is_seeded(self):
        a, b = MLP([4, 3], seed=5, device=CPU), MLP([4, 3], seed=5, device=CPU)
        assert torch.equal(a.weights[0], b.weights[0])
        assert not torch.any(a.biases[0])


class TestKMeans:
    @pytest.mark.parametrize("num_blocks,num_iters", [(1, 1), (4, 3)])
    def test_matches_the_jax_kmeans(self, num_blocks, num_iters):
        rng = np.random.default_rng(0)
        blobs = rng.standard_normal((3, 5)) * 6
        pts = (blobs[rng.integers(0, 3, 400)] + rng.standard_normal((400, 5))).astype(np.float32)
        data = {"features": pts}
        jc, jn = j_kmeans(tfs.TensorFrame.from_dict(data, num_blocks=num_blocks),
                          "features", k=3, num_iters=num_iters, seed=7)
        tc, tn = kmeans(tft.TensorFrame.from_dict(data, num_blocks=num_blocks),
                        "features", k=3, num_iters=num_iters, seed=7, device=CPU)
        assert tc.dtype == np.asarray(jc).dtype == np.float32
        np.testing.assert_array_equal(tn, np.asarray(jn))
        np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-5, atol=1e-6)

    def test_points_on_the_device_and_one_lowering(self):
        from tensorframes_tpu_torch.runtime.executor import default_executor

        pts = np.random.default_rng(1).standard_normal((90, 2)).astype(np.float32)
        host = tft.TensorFrame.from_dict({"p": pts}, num_blocks=3)
        dev = host.to_device(CPU)
        before = default_executor().compile_count
        a = kmeans(host, "p", k=4, num_iters=4, seed=2, device=CPU)
        after_first = default_executor().compile_count
        b = kmeans(dev, "p", k=4, num_iters=4, seed=2, device=CPU)
        # one lowering per distinct graph, whatever the bound centres
        assert after_first - before <= 1 and default_executor().compile_count == after_first
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])

    def test_needs_a_vector_column_and_an_iteration(self):
        tdf = tft.TensorFrame.from_dict({"p": np.zeros(4, np.float32)})
        with pytest.raises(ValueError, match="rank-1"):
            kmeans(tdf, "p", k=2, device=CPU)
        with pytest.raises(ValueError, match="num_iters"):
            kmeans(tdf, "p", k=2, num_iters=0, device=CPU)


class TestInceptionLite:
    @pytest.mark.parametrize(
        "kw",
        [dict(image_size=16, width=4, seed=0), dict(image_size=32, width=8, num_classes=10, seed=3),
         dict(image_size=299, width=32, num_classes=1000, seed=0)],
        ids=["tiny", "default-widths", "smoke-widths"],
    )
    def test_scoring_graph_bytes_equal_the_jax_model(self, kw):
        """The weights live in the GraphDef: equal bytes carry them over."""
        jg, jf = jdsl.build(JInceptionLite(**kw).scoring_graph())
        tg, tf_ = tft.dsl.build(InceptionLite(**kw).scoring_graph())
        assert tf_ == jf == ["probs"]
        assert tg.to_bytes() == jg.to_bytes()
        assert tft.InceptionLite is InceptionLite

    def test_probabilities_match_the_jax_model(self):
        raw = jdsl.build(JInceptionLite(image_size=16, width=4, seed=0).scoring_graph())[0].to_bytes()
        imgs = np.random.default_rng(0).standard_normal((12, 16, 16, 3)).astype(np.float32)
        ref = np.asarray(tfs.map_blocks(
            raw, tfs.TensorFrame.from_dict({"images": imgs}, num_blocks=3),
            fetch_names=["probs"], trim=True,
        )["probs"].values)
        got = tft.map_blocks(
            raw, tft.TensorFrame.from_dict({"images": imgs}, num_blocks=3),
            fetch_names=["probs"], trim=True, device=CPU,
        ).host_values("probs")
        assert got.shape == ref.shape == (12, 10) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def _freeze_keras_inception(tmp_path, hw=75, batch=2):
    """Keras Inception-v3, frozen in a child process by the benchmark's
    `benchmarks._util.freeze_keras_model` (TF2 freezing needs eager mode,
    which another test module may have turned off in this process)."""
    pytest.importorskip("tensorflow")
    pb, npz = tmp_path / "iv3.pb", tmp_path / "iv3.npz"
    code = (
        "import os\n"
        "os.environ.setdefault('CUDA_VISIBLE_DEVICES', '-1')\n"
        "os.environ.setdefault('TF_CPP_MIN_LOG_LEVEL', '2')\n"
        "import numpy as np\n"
        "from benchmarks._util import freeze_keras_model\n"
        f"wire, innode, outnode, _ = freeze_keras_model('InceptionV3', {hw})\n"
        f"feeds = np.random.default_rng(0).normal(size=({batch}, {hw}, {hw}, 3)).astype(np.float32)\n"
        f"open({str(pb)!r}, 'wb').write(wire)\n"
        f"np.savez({str(npz)!r}, feeds=feeds, innode=innode, outnode=outnode)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    d = np.load(npz)
    return pb.read_bytes(), str(d["innode"]), str(d["outnode"]), d["feeds"]


def test_frozen_keras_inception_v3_matches_the_jax_package(tmp_path):
    """The real Keras graph (2,000+ nodes, ~96 MB of frozen constants) at
    its smallest input, 75x75, scored by both packages on the CPU."""
    wire, in_node, out_node, images = _freeze_keras_inception(tmp_path)
    assert len(wire) > 50_000_000
    ref = np.asarray(tfs.map_blocks(
        wire, tfs.TensorFrame.from_dict({"images": images}),
        fetch_names=[out_node], feed_dict={in_node: "images"},
    )[out_node].values)
    got = tft.map_blocks(
        wire, tft.TensorFrame.from_dict({"images": images}),
        fetch_names=[out_node], feed_dict={in_node: "images"}, device=CPU,
    ).host_values(out_node)
    assert got.shape == ref.shape == (2, 1000)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))
