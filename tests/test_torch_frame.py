"""PyTorch port: frame, schema, GraphDef interchange, device rules and the
import guard. Inputs come from seeded numpy and go through both packages
where both have the function."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.graph import builder as jdsl
from tensorframes_tpu_torch import dsl as tdsl
from tensorframes_tpu_torch.graph.ir import Graph as TGraph
from tensorframes_tpu_torch.models import TransformerLM
from tensorframes_tpu_torch.schema import ScalarType, UnsupportedTypeError

CPU = "cpu"


def _rng():
    return np.random.default_rng(0)


class TestFrame:
    def test_from_dict_blocks_offsets_match_reference(self):
        data = {"x": _rng().standard_normal(23), "k": np.arange(23)}
        ref = tfs.TensorFrame.from_dict(data, num_blocks=4)
        port = tft.TensorFrame.from_dict(data, num_blocks=4)
        assert port.offsets == [int(o) for o in ref.offsets]
        assert port.block_sizes() == ref.block_sizes()
        assert port.columns == ref.columns
        for pb, rb in zip(port.blocks(), ref.blocks()):
            np.testing.assert_array_equal(pb.host_values("x"), rb.host_values("x"))

    @pytest.mark.parametrize(
        "dtype", [np.float64, np.float32, np.int64, np.int32, np.bool_]
    )
    def test_dtype_kept_through_device_and_back(self, dtype):
        arr = (_rng().standard_normal((6, 3)) * 10).astype(dtype)
        df = tft.TensorFrame.from_dict({"x": arr}).to_device(CPU)
        col = df.column("x")
        assert isinstance(col.values, torch.Tensor)
        assert col.values.dtype == ScalarType.from_np_dtype(arr.dtype).torch_dtype
        assert col.info.dtype.value == tfs.TensorFrame.from_dict(
            {"x": arr}
        ).info["x"].dtype.value
        back = df.host_values("x")
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back, arr)

    def test_cell_shape_and_schema(self):
        df = tft.TensorFrame.from_dict({"v": np.zeros((5, 2, 3), np.float32)})
        assert df.info["v"].cell_shape.dims == (2, 3)
        assert df.info["v"].block_shape.dims == (None, 2, 3)
        assert repr(tft.analyze(df)) == repr(df)

    def test_repartition_and_select(self):
        df = tft.TensorFrame.from_dict({"a": np.arange(10), "b": np.ones(10)})
        assert df.repartition(3).num_blocks == 3
        assert df.select(["b"]).columns == ["b"]
        with pytest.raises(ValueError):
            df.repartition(0)

    def test_host_values_is_cached(self):
        df = tft.TensorFrame.from_dict({"x": np.arange(4.0)}).to_device(CPU)
        assert df.host_values("x") is df.host_values("x")

    def test_string_and_ragged_columns_refused(self):
        """String and ragged columns are host columns, as in the reference;
        only the device refuses them (`as_tensor`)."""
        data = {
            "s": np.array(["a", "b", "a"], dtype=object),
            "u": np.array(["a", "bc", "d"]),
            "r": [np.arange(2.0), np.arange(3.0), np.arange(1.0)],
        }
        port, ref = tft.TensorFrame.from_dict(data), tfs.TensorFrame.from_dict(data)
        assert repr(port) == repr(ref)
        for name in data:
            assert port[name].is_dense == ref[name].is_dense
            assert port[name].device is None
        assert port.host_values("s").tolist() == ["a", "b", "a"]
        assert port.host_values("u").tolist() == ref.host_values("u").tolist()
        for got, want in zip(port["r"].rows(), ref["r"].rows()):
            np.testing.assert_array_equal(got, want)
        for name in ("s", "u"):
            with pytest.raises(UnsupportedTypeError, match="strings stay on the host"):
                tft.frame.as_tensor(port.host_values(name), torch.device(CPU))

    def test_uint32_refused_on_device(self):
        df = tft.TensorFrame.from_dict({"u": np.arange(3, dtype=np.uint32)})
        with pytest.raises(UnsupportedTypeError, match="uint32"):
            df.to_device(CPU)

    def test_bad_offsets(self):
        with pytest.raises(ValueError):
            tft.TensorFrame([tft.Column("x", np.arange(3))], offsets=[0, 2])


class TestSchema:
    @pytest.mark.parametrize(
        "name",
        ["float64", "float32", "bfloat16", "float16", "int64", "int32",
         "int16", "int8", "uint8", "bool_"],
    )
    def test_torch_dtype_round_trip(self, name):
        st = getattr(ScalarType, name)
        assert ScalarType.from_torch_dtype(st.torch_dtype) is st
        # the port's enum keeps the reference's values and TF wire numbers
        ref = getattr(tfs.ScalarType, name)
        assert (st.value, st.tf_datatype) == (ref.value, ref.tf_datatype)

    @pytest.mark.parametrize("name", ["uint32", "uint64", "string"])
    def test_types_torch_cannot_compute_are_refused(self, name):
        with pytest.raises(UnsupportedTypeError):
            getattr(ScalarType, name).torch_dtype


def _programs():
    """(name, builder): each builder takes (dsl, frame) and returns fetches."""

    def x_plus_3(d, f):
        return (d.block(f, "x") + 3.0).named("z")

    def reduce_sum(d, f):
        return d.reduce_sum(d.block(f, "x", tf_name="x_input"), axes=[0]).named("x")

    def mlp_like(d, f):
        w = d.constant(np.eye(3, dtype=np.float64), name="w")
        h = d.relu(d.matmul(d.block(f, "v"), w))
        return d.softmax(d.reshape(h, [-1, 3])).named("p")

    return [("x_plus_3", x_plus_3), ("reduce_sum", reduce_sum), ("mlp_like", mlp_like)]


class TestGraphDefInterchange:
    @pytest.mark.parametrize("name,prog", _programs())
    def test_dsl_emits_the_reference_bytes(self, name, prog):
        data = {"x": np.arange(4.0), "v": np.ones((4, 3))}
        jg, jf = jdsl.build(prog(jdsl, tfs.TensorFrame.from_dict(data)))
        tg, tf_ = tdsl.build(prog(tdsl, tft.TensorFrame.from_dict(data)))
        assert tf_ == jf
        assert tg.to_bytes() == jg.to_bytes()

    @pytest.mark.parametrize("name,prog", _programs())
    def test_port_parses_reference_bytes(self, name, prog):
        data = {"x": np.arange(4.0), "v": np.ones((4, 3))}
        jg, _ = jdsl.build(prog(jdsl, tfs.TensorFrame.from_dict(data)))
        raw = jg.to_bytes()
        tg = TGraph.from_bytes(raw)
        assert [n.name for n in tg] == [n.name for n in jg]
        assert tg.to_bytes() == raw
        assert tg.fingerprint() == jg.fingerprint()


class TestDevice:
    def test_verbs_and_models_refuse_to_run_on_the_cpu_unasked(self, monkeypatch):
        # no card: device=None must raise, never quietly run on the CPU
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        df = tft.TensorFrame.from_dict({"x": np.arange(4.0)})
        z = (tft.block(df, "x") + 3.0).named("z")
        for call in (
            lambda: tft.map_blocks(z, df),
            lambda: tft.map_rows((tft.row(df, "x") * 2.0).named("y"), df),
            lambda: df.to_device(),
            lambda: tft.map_blocks(z, df, device="cuda"),
            lambda: TransformerLM(vocab=8, d_model=8, n_heads=2, n_layers=1),
        ):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()

    def test_cpu_on_request(self):
        df = tft.TensorFrame.from_dict({"x": np.arange(4.0)})
        z = (tft.block(df, "x") + 3.0).named("z")
        out = tft.map_blocks(z, df, device=torch.device("cpu"))
        assert out.column("z").device == torch.device("cpu")

    def test_float32_matmul_precision_is_full(self):
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False


def test_import_guard_no_pandas_or_pyarrow():
    """The port must load where neither pandas nor pyarrow is installed:
    importing it, and its I/O module, loads neither."""
    code = textwrap.dedent(
        """
        import sys
        import tensorframes_tpu_torch
        import tensorframes_tpu_torch.io
        import tensorframes_tpu_torch.fn_frontend
        import tensorframes_tpu_torch.frame
        import tensorframes_tpu_torch.ingest
        import tensorframes_tpu_torch.runtime.checkpoint
        import tensorframes_tpu_torch.streaming
        bad = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("pandas", "pyarrow")
        )
        print(bad)
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_import_guard_no_jax():
    """Importing the port (and running the verbs, imported graphs with
    control flow and variables among them) loads neither jax nor any module
    of the JAX package."""
    code = textwrap.dedent(
        """
        import sys
        import numpy as np
        import tensorframes_tpu_torch as tft
        import tensorframes_tpu_torch.aggregate
        import tensorframes_tpu_torch.fn_frontend
        import tensorframes_tpu_torch.graph.control_flow
        import tensorframes_tpu_torch.graph.freeze
        import tensorframes_tpu_torch.graph.vectorize
        import tensorframes_tpu_torch.models
        import tensorframes_tpu_torch.models.inception
        import tensorframes_tpu_torch.models.kmeans
        import tensorframes_tpu_torch.models.mlp
        import tensorframes_tpu_torch.ops.control
        import tensorframes_tpu_torch.ops.flash_attention
        import tensorframes_tpu_torch.ops.standard
        import tensorframes_tpu_torch.tools.profile_imported
        import tensorframes_tpu_torch.utils.profiling
        import tensorframes_tpu_torch.config
        import tensorframes_tpu_torch.ingest.dataset
        import tensorframes_tpu_torch.ingest.pipeline
        import tensorframes_tpu_torch.runtime.checkpoint
        import tensorframes_tpu_torch.runtime.deadline
        import tensorframes_tpu_torch.runtime.faults
        import tensorframes_tpu_torch.runtime.retry
        import tensorframes_tpu_torch.streaming
        import tensorframes_tpu_torch.testing.faults
        import tensorframes_tpu_torch.utils.log
        import tensorframes_tpu_torch.utils.telemetry
        df = tft.TensorFrame.from_dict(
            {"x": np.arange(6.0), "k": np.array([0, 1, 0, 1, 2, 2])}, num_blocks=2
        )
        tft.map_blocks((tft.block(df, "x") + 1.0).named("y"), df, device="cpu")
        s = tft.dsl.reduce_mean(tft.block(df, "x", tf_name="x_input"), axes=[0])
        tft.aggregate(s.named("x"), tft.group_by(df, "k"), device="cpu")
        x1 = tft.dsl.placeholder(tft.ScalarType.float64, tft.Shape(()), name="x_1")
        x2 = tft.dsl.placeholder(tft.ScalarType.float64, tft.Shape(()), name="x_2")
        tft.reduce_rows((x1 * 0.5 + x2).named("x"), df, device="cpu")
        tft.map_rows(lambda x, w: {"y": x * w}, df, bindings={"w": 2.0}, device="cpu")
        rag = tft.TensorFrame.from_dict(
            {"v": [np.arange(2.0), np.arange(3.0)], "s": np.array(["a", "b"], dtype=object)}
        )
        tft.map_rows(tft.dsl.reduce_sum(tft.row(rag, "v"), axes=[0]).named("t"), rag, device="cpu")
        tft.aggregate(s.named("x"), tft.group_by(
            tft.TensorFrame.from_dict({"x": np.arange(2.0), "s": rag.host_values("s")}), "s"
        ), device="cpu")
        pts = tft.TensorFrame.from_dict({"p": np.arange(12.0).reshape(6, 2)})
        tensorframes_tpu_torch.models.kmeans(pts, "p", 2, 1, device="cpu")
        fixtures = "tests/fixtures/torch_port/"
        xs = tft.TensorFrame.from_dict({"x": np.linspace(-9, 9, 7).astype(np.float32)})
        tft.map_rows(fixtures + "branchy_v1.pb", xs, fetch_names=["out"], device="cpu")
        tft.map_blocks(fixtures + "var_resource.pb", xs, fetch_names=["z"], device="cpu")
        g, _ = tft.dsl.build(tft.InceptionLite(image_size=16, width=4).scoring_graph())
        imgs = tft.TensorFrame.from_dict({"images": np.zeros((2, 16, 16, 3), np.float32)})
        tft.map_blocks(g.to_bytes(), imgs, fetch_names=["probs"], trim=True, device="cpu")
        chunks = [tft.TensorFrame.from_dict({"x": np.arange(4.0) + i}) for i in range(3)]
        sx = tft.dsl.reduce_sum(tft.block(chunks[0], "x", tf_name="x_input"), axes=[0])
        tft.reduce_blocks_stream(sx.named("x"), iter(chunks), device="cpu", timeout_s=60)
        bad = sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith("jax.") or m == "jaxlib"
            or m == "tensorframes_tpu" or m.startswith("tensorframes_tpu.")
        )
        print(bad)
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
