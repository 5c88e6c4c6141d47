"""PyTorch port: durable streams (`runtime/checkpoint.py` and
`reduce_blocks_stream(checkpoint=)`), held to the JAX package on the CPU.

Mirrors `tests/test_checkpoint.py`: the store's atomic commit and its
refusal of torn, garbled or foreign files; the eligibility gate; periodic,
clean-exit and final commits; resume (task-metadata skip, plain-iterator
re-pull, after a `DeadlineExceeded`, in a fresh interpreter); drift
refusal naming the field. The manifest the port writes has the JAX
package's fields, and the same program and dataset fingerprints for the
same graph and shards. A resumed stream is bit-identical to the port's own
uninterrupted stream for exact monoids (integer sum, min, max) and within
rtol 1e-5 for a float32 sum.
"""

import hashlib
import json
import os
import struct
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu.runtime.checkpoint import CheckpointStore as JStore
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch import io as tio
from tensorframes_tpu_torch.runtime import checkpoint as ckpt_mod
from tensorframes_tpu_torch.runtime import deadline as tdl
from tensorframes_tpu_torch.runtime import faults as tfaults
from tensorframes_tpu_torch.runtime.checkpoint import (
    MAGIC,
    SCHEMA_VERSION,
    CheckpointError,
    CheckpointStore,
)
from tensorframes_tpu_torch.testing import faults as chaos
from tensorframes_tpu_torch.utils import profiling as tprof
from tensorframes_tpu_torch.utils import telemetry as ttele

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytest.importorskip("pyarrow")


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    ttele.reset()
    tprof.reset_stats()
    tfaults.reset_ledger()
    tdl.reset()
    ckpt_mod.reset_state()


def _write_int_shards(root, shards=4, rows=64, blocks=2, seed=0):
    """One Parquet shard per entry, an int64 column (exact monoids)."""
    rng = np.random.RandomState(seed)
    parts = []
    for i in range(shards):
        x = rng.randint(0, 100000, size=rows).astype(np.int64)
        parts.append(x)
        df = tft.TensorFrame.from_dict({"x": x}, num_blocks=blocks)
        tio.write_parquet(df, str(root / f"shard-{i:03d}.parquet"))
    return np.concatenate(parts)


def _probe(pkg):
    return pkg.TensorFrame.from_dict({"x": np.arange(2).astype(np.int64)})


def _sum_fetch(pkg=tft):
    return pkg.dsl.reduce_sum(pkg.block(_probe(pkg), "x", tf_name="x_input"), axes=[0]).named("x")


_FEED = {"s_input": "x", "mn_input": "x", "mx_input": "x"}


def _monoid_fetches(pkg=tft):
    probe = _probe(pkg)
    return [
        pkg.dsl.reduce_sum(pkg.block(probe, "x", tf_name="s_input"), axes=[0]).named("s"),
        pkg.dsl.reduce_min(pkg.block(probe, "x", tf_name="mn_input"), axes=[0]).named("mn"),
        pkg.dsl.reduce_max(pkg.block(probe, "x", tf_name="mx_input"), axes=[0]).named("mx"),
    ]


def _stream(fetches, source, feed=None, **kw):
    return tft.reduce_blocks_stream(fetches, source, feed, device=CPU, **kw)


def _decode_count():
    return sum(
        v
        for (name, labels), v in ttele.labeled_counters().items()
        if name == "ingest_chunks" and dict(labels).get("stage") == "decode"
    )


def _wait_ingest_threads_gone(timeout=10.0):
    end = time.time() + timeout
    while time.time() < end and any(
        t.name.startswith("tfs-ingest") for t in threading.enumerate()
    ):
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


class TestStore:
    def test_commit_load_round_trip(self, tmp_path):
        store = CheckpointStore(tmp_path / "ck")
        payload = b"payload-bytes" * 100
        store.commit({"watermark": 7, "foo": "bar"}, payload)
        manifest, loaded = store.load()
        assert loaded == payload
        assert manifest["watermark"] == 7 and manifest["foo"] == "bar"
        assert manifest["schema_version"] == SCHEMA_VERSION
        assert manifest["payload_len"] == len(payload)
        assert manifest["payload_sha256"] == hashlib.sha256(payload).hexdigest()

    def test_files_are_interchangeable_with_jax(self, tmp_path):
        CheckpointStore(tmp_path / "a").commit({"watermark": 3}, b"xyz")
        JStore(tmp_path / "b").commit({"watermark": 3}, b"xyz")
        ma, pa = CheckpointStore(tmp_path / "b").load()
        mb, pb = JStore(tmp_path / "a").load()
        assert pa == pb == b"xyz" and ma["watermark"] == mb["watermark"] == 3

    def test_commit_is_atomic_no_tmp_left(self, tmp_path):
        store = CheckpointStore(tmp_path / "ck")
        store.commit({"watermark": 1}, b"abc")
        store.commit({"watermark": 2}, b"def")
        assert [p.name for p in tmp_path.iterdir()] == ["ck"]
        manifest, payload = store.load()
        assert manifest["watermark"] == 2 and payload == b"def"

    def test_commit_reaps_stale_tmp_from_dead_pid_only(self, tmp_path):
        dead = subprocess.Popen([sys.executable, "-c", ""])
        dead.wait()
        (tmp_path / f"ck.tmp.{dead.pid}").write_bytes(b"orphan" * 1000)
        live_pid = os.getppid()
        (tmp_path / f"ck.tmp.{live_pid}").write_bytes(b"live")
        CheckpointStore(tmp_path / "ck").commit({"watermark": 1}, b"abc")
        assert sorted(p.name for p in tmp_path.iterdir()) == ["ck", f"ck.tmp.{live_pid}"]

    @pytest.mark.parametrize("damage", ["truncate", "garble", "magic"])
    def test_torn_file_refused(self, damage, tmp_path):
        store = CheckpointStore(tmp_path / "ck")
        store.commit({"watermark": 3}, b"x" * 4096)
        blob = bytearray((tmp_path / "ck").read_bytes())
        if damage == "truncate":
            blob = blob[: len(blob) // 2]
        elif damage == "garble":
            blob[-100] ^= 0xFF
        else:
            blob[:8] = b"NOTACKPT"
        (tmp_path / "ck").write_bytes(bytes(blob))
        with pytest.raises(CheckpointError) as ei:
            store.load()
        assert ei.value.kind == "corrupt"
        if damage == "garble":
            assert "checksum" in str(ei.value)

    def test_stale_schema_version_refused(self, tmp_path):
        payload = b"future-payload"
        manifest = {
            "schema_version": SCHEMA_VERSION + 1,
            "payload_len": len(payload),
            "payload_sha256": hashlib.sha256(payload).hexdigest(),
        }
        mbytes = json.dumps(manifest, sort_keys=True).encode()
        blob = MAGIC + struct.pack(">Q", len(mbytes)) + mbytes + struct.pack(">Q", len(payload)) + payload
        (tmp_path / "ck").write_bytes(blob)
        with pytest.raises(CheckpointError) as ei:
            CheckpointStore(tmp_path / "ck").load()
        assert ei.value.kind == "drift" and ei.value.field == "schema_version"


# ---------------------------------------------------------------------------
# the manifest, held to the JAX package's
# ---------------------------------------------------------------------------


class TestManifestParity:
    @pytest.mark.parametrize("every", [1, 3])
    def test_same_fields_and_fingerprints_as_jax(self, every, tmp_path):
        data = tmp_path / "data"
        data.mkdir()
        _write_int_shards(data, shards=3)
        port_ck, jax_ck = tmp_path / "port", tmp_path / "jax"
        out = _stream(
            _monoid_fetches(), tft.stream_dataset(str(data)), _FEED,
            checkpoint=str(port_ck), checkpoint_every=every,
        )
        want = tfs.reduce_blocks_stream(
            _monoid_fetches(tfs), tfs.stream_dataset(str(data)), _FEED,
            checkpoint=str(jax_ck), checkpoint_every=every,
        )
        for k in ("s", "mn", "mx"):
            assert out[k].item() == int(np.asarray(want[k]))
        pm, _ = CheckpointStore(port_ck).load()
        jm, _ = JStore(jax_ck).load()
        assert sorted(pm) == sorted(jm)
        for field in (
            "fetch_names", "program_fingerprint", "dataset_fingerprint",
            "monoids", "fold_every", "watermark", "partials", "schema_version",
        ):
            assert pm[field] == jm[field], field
        # the digest covers each package's own numerics knobs
        assert pm["config_digest"] == ckpt_mod.config_digest()

    def test_payload_round_trips_vector_partials(self, tmp_path):
        parts = [{"v": np.arange(4.0, dtype=np.float32) + i, "s": np.int64(i)} for i in range(3)]
        payload, synced = ckpt_mod.partials_to_payload(parts, ["v", "s"])
        assert not synced
        back = ckpt_mod.payload_to_partials(
            payload, {"partials": 3, "fetch_names": ["v", "s"]}, CheckpointStore(tmp_path / "x")
        )
        for a, b in zip(parts, back):
            np.testing.assert_array_equal(a["v"], b["v"])
            assert a["s"] == b["s"]
        import torch

        _, synced = ckpt_mod.partials_to_payload([{"v": torch.ones(4)}], ["v"])
        assert synced


# ---------------------------------------------------------------------------
# eligibility + argument validation
# ---------------------------------------------------------------------------


class TestEligibility:
    def test_non_classifiable_reduce_rejected_at_entry(self, tmp_path):
        _write_int_shards(tmp_path, shards=2)
        xi = tft.block(_probe(tft), "x", tf_name="x_input")
        bad = tft.dsl.mul(xi, xi).named("y")
        ttele.reset()
        with pytest.raises(CheckpointError) as ei:
            _stream(bad, tft.stream_dataset(str(tmp_path)), checkpoint=str(tmp_path / "ck"))
        assert ei.value.kind == "ineligible"
        assert _decode_count() == 0
        assert not (tmp_path / "ck").exists()

    def test_bad_checkpoint_every_and_resume_values(self, tmp_path):
        _write_int_shards(tmp_path, shards=1)
        with pytest.raises(CheckpointError):
            _stream(_sum_fetch(), tft.stream_dataset(str(tmp_path)),
                    checkpoint=str(tmp_path / "ck"), checkpoint_every=0)
        with pytest.raises(CheckpointError):
            _stream(_sum_fetch(), tft.stream_dataset(str(tmp_path)),
                    checkpoint=str(tmp_path / "ck"), resume="maybe")


# ---------------------------------------------------------------------------
# commit / resume
# ---------------------------------------------------------------------------


class TestCommitResume:
    def test_full_run_bit_identical_and_commits(self, tmp_path):
        allx = _write_int_shards(tmp_path, shards=4)
        ck = tmp_path / "ck"
        plain = _stream(_monoid_fetches(), tft.stream_dataset(str(tmp_path)), _FEED)
        ckpt_mod.reset_state()
        out = _stream(_monoid_fetches(), tft.stream_dataset(str(tmp_path)), _FEED,
                      checkpoint=str(ck), checkpoint_every=2)
        for k in ("s", "mn", "mx"):
            assert out[k].item() == plain[k].item()
        assert out["s"].item() == int(allx.sum())
        st = ckpt_mod.state()
        assert st["commits"] >= 2 and st["last_commit"]["watermark"] == 8

    def test_resume_of_completed_run_decodes_nothing(self, tmp_path):
        allx = _write_int_shards(tmp_path, shards=3)
        ck = tmp_path / "ck"
        _stream(_sum_fetch(), tft.stream_dataset(str(tmp_path)), checkpoint=str(ck), checkpoint_every=1)
        ttele.reset()
        ckpt_mod.reset_state()
        out = _stream(_sum_fetch(), tft.stream_dataset(str(tmp_path)), checkpoint=str(ck), checkpoint_every=1)
        assert out.item() == int(allx.sum())
        assert _decode_count() == 0
        st = ckpt_mod.state()
        assert st["resumes"] == 1 and st["chunks_skipped"] == 6 and st["commits"] == 0
        assert ttele.flat_counters()["checkpoint_chunks_skipped"] == 6

    def test_deadline_interrupt_commits_then_resume_bit_identical(self, tmp_path):
        _write_int_shards(tmp_path, shards=6, rows=64)
        ck = tmp_path / "ck"
        plain = _stream(_monoid_fetches(), tft.stream_dataset(str(tmp_path)), _FEED)
        # one decode worker: hook attempt 8 is chunk 8 (a pool may take
        # chunks' hook calls out of order)
        with chaos.inject_stage(stage="decode", nth=[8], fault="hang", delay_s=30.0):
            with pytest.raises(tft.DeadlineExceeded) as ei:
                _stream(_monoid_fetches(), tft.stream_dataset(str(tmp_path), decode_workers=1),
                        _FEED, checkpoint=str(ck), checkpoint_every=1, timeout_s=2.5)
        wm = ei.value.tfs_checkpoint_watermark
        assert ei.value.tfs_checkpoint_path == str(ck)
        assert wm is not None and 1 <= wm <= 8
        manifest, _ = CheckpointStore(ck).load()
        assert manifest["watermark"] == wm
        assert manifest["monoids"] == {"s": "sum", "mn": "min", "mx": "max"}
        _wait_ingest_threads_gone()
        ttele.reset()
        out = _stream(_monoid_fetches(), tft.stream_dataset(str(tmp_path)), _FEED,
                      checkpoint=str(ck), checkpoint_every=1)
        for k in ("s", "mn", "mx"):
            assert out[k].item() == plain[k].item()
        assert _decode_count() <= 12 - wm

    def test_plain_iterator_checkpoint_and_resume(self, tmp_path):
        rng = np.random.RandomState(3)
        chunks = [rng.randint(0, 1000, size=32).astype(np.int64) for _ in range(5)]

        def frames():
            return [tft.TensorFrame.from_dict({"x": c}) for c in chunks]

        expected = int(np.concatenate(chunks).sum())
        ck = tmp_path / "ck"
        assert _stream(_sum_fetch(), frames(), checkpoint=str(ck), checkpoint_every=2).item() == expected
        manifest, _ = CheckpointStore(ck).load()
        assert manifest["dataset_fingerprint"] is None
        ckpt_mod.reset_state()
        assert _stream(_sum_fetch(), frames(), checkpoint=str(ck), checkpoint_every=2).item() == expected
        st = ckpt_mod.state()
        assert st["resumes"] == 1 and st["chunks_skipped"] == 0

    def test_rank2_partials_refused_at_first_fold(self, tmp_path):
        chunks = [tft.TensorFrame.from_dict({"x": np.ones((8, 2, 2))}) for _ in range(3)]
        probe = tft.TensorFrame.from_dict({"x": np.ones((2, 2, 2))})
        fetch = tft.dsl.reduce_sum(tft.block(probe, "x", tf_name="x_input"), axes=[0]).named("x")
        with pytest.raises(CheckpointError) as ei:
            _stream(fetch, iter(chunks), checkpoint=str(tmp_path / "ck"), checkpoint_every=100)
        assert ei.value.field == "x" and "rank-2" in str(ei.value)
        assert not (tmp_path / "ck").exists()

    def test_failed_final_commit_returns_the_result(self, tmp_path, monkeypatch):
        allx = _write_int_shards(tmp_path, shards=2)
        monkeypatch.setattr(
            CheckpointStore, "commit",
            lambda self, *a, **k: (_ for _ in ()).throw(CheckpointError("disk full", path=self.path)),
        )
        out = _stream(_sum_fetch(), tft.stream_dataset(str(tmp_path)),
                      checkpoint=str(tmp_path / "ck"), checkpoint_every=100)
        assert out.item() == int(allx.sum())
        assert not (tmp_path / "ck").exists()

    def test_zero_row_chunks_advance_watermark(self, tmp_path):
        rng = np.random.RandomState(4)
        xs = [rng.randint(0, 9, size=16).astype(np.int64) for _ in range(3)]

        def frames():
            empty = tft.TensorFrame.from_dict({"x": np.zeros(0, np.int64)})
            return [tft.TensorFrame.from_dict({"x": xs[0]}), empty,
                    tft.TensorFrame.from_dict({"x": xs[1]}), empty,
                    tft.TensorFrame.from_dict({"x": xs[2]})]

        ck = tmp_path / "ck"
        want = int(np.concatenate(xs).sum())
        assert _stream(_sum_fetch(), frames(), checkpoint=str(ck), checkpoint_every=1).item() == want
        assert CheckpointStore(ck).load()[0]["watermark"] == 5
        assert _stream(_sum_fetch(), frames(), checkpoint=str(ck), checkpoint_every=1).item() == want

    def test_float_sum_within_tolerance(self, tmp_path):
        rng = np.random.RandomState(5)
        for i in range(3):
            df = tft.TensorFrame.from_dict({"x": rng.rand(128).astype(np.float32)}, num_blocks=2)
            tio.write_parquet(df, str(tmp_path / f"s-{i}.parquet"))
        probe = tft.TensorFrame.from_dict({"x": np.arange(2, dtype=np.float32)})
        fetch = tft.dsl.reduce_sum(tft.block(probe, "x", tf_name="x_input"), axes=[0]).named("x")
        plain = _stream(fetch, tft.stream_dataset(str(tmp_path)))
        out = _stream(fetch, tft.stream_dataset(str(tmp_path)),
                      checkpoint=str(tmp_path / "ck"), checkpoint_every=2)
        np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-5)

    def test_config_knob_default_cadence(self, tmp_path):
        _write_int_shards(tmp_path, shards=2)
        with tconfig.override(stream_checkpoint_every=1):
            ckpt_mod.reset_state()
            _stream(_sum_fetch(), tft.stream_dataset(str(tmp_path)), checkpoint=str(tmp_path / "ck"))
            assert ckpt_mod.state()["commits"] == 4


# ---------------------------------------------------------------------------
# drift refusal + resume="ignore"
# ---------------------------------------------------------------------------


class TestDriftRefusal:
    def _committed(self, tmp_path, shards=3):
        _write_int_shards(tmp_path, shards=shards)
        ck = tmp_path / "ck"
        _stream(_sum_fetch(), tft.stream_dataset(str(tmp_path)), checkpoint=str(ck), checkpoint_every=1)
        return ck

    def test_drifted_dataset_refused(self, tmp_path):
        ck = self._committed(tmp_path)
        df = tft.TensorFrame.from_dict({"x": np.arange(16).astype(np.int64)}, num_blocks=2)
        tio.write_parquet(df, str(tmp_path / "shard-zzz.parquet"))
        with pytest.raises(CheckpointError) as ei:
            _stream(_sum_fetch(), tft.stream_dataset(str(tmp_path)), checkpoint=str(ck))
        assert ei.value.kind == "drift" and ei.value.field == "dataset_fingerprint"
        assert "dataset_fingerprint" in str(ei.value)

    def test_drifted_program_refused(self, tmp_path):
        ck = self._committed(tmp_path)
        other = tft.dsl.reduce_min(tft.block(_probe(tft), "x", tf_name="x_input"), axes=[0]).named("x")
        with pytest.raises(CheckpointError) as ei:
            _stream(other, tft.stream_dataset(str(tmp_path)), checkpoint=str(ck))
        assert ei.value.field == "program_fingerprint"

    def test_drifted_config_refused(self, tmp_path):
        ck = self._committed(tmp_path)
        with tconfig.override(check_numerics=True):
            with pytest.raises(CheckpointError) as ei:
                _stream(_sum_fetch(), tft.stream_dataset(str(tmp_path)), checkpoint=str(ck))
        assert ei.value.field == "config_digest"

    def test_torn_checkpoint_refused_not_silently_restarted(self, tmp_path):
        ck = self._committed(tmp_path)
        blob = ck.read_bytes()
        ck.write_bytes(blob[: len(blob) - 32])
        with pytest.raises(CheckpointError) as ei:
            _stream(_sum_fetch(), tft.stream_dataset(str(tmp_path)), checkpoint=str(ck))
        assert ei.value.kind == "corrupt"

    def test_resume_ignore_restarts_from_zero(self, tmp_path):
        allx = _write_int_shards(tmp_path, shards=3)
        ck = tmp_path / "ck"
        ck.write_bytes(b"garbage that is definitely not a checkpoint")
        ckpt_mod.reset_state()
        out = _stream(_sum_fetch(), tft.stream_dataset(str(tmp_path)),
                      checkpoint=str(ck), checkpoint_every=1, resume="ignore")
        assert out.item() == int(allx.sum())
        st = ckpt_mod.state()
        assert st["ignored"] == 1 and st["resumes"] == 0
        assert CheckpointStore(ck).load()[0]["watermark"] == 6


# ---------------------------------------------------------------------------
# resume in a fresh interpreter
# ---------------------------------------------------------------------------

_CHILD = textwrap.dedent(
    """
    import json, sys
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.utils import telemetry

    root, ck = sys.argv[1], sys.argv[2]
    probe = tft.TensorFrame.from_dict({"x": __import__("numpy").arange(2).astype("int64")})
    fetches = [
        tft.dsl.reduce_sum(tft.block(probe, "x", tf_name="s_input"), axes=[0]).named("s"),
        tft.dsl.reduce_min(tft.block(probe, "x", tf_name="mn_input"), axes=[0]).named("mn"),
        tft.dsl.reduce_max(tft.block(probe, "x", tf_name="mx_input"), axes=[0]).named("mx"),
    ]
    feed = {"s_input": "x", "mn_input": "x", "mx_input": "x"}
    out = tft.reduce_blocks_stream(
        fetches, tft.stream_dataset(root), feed, device="cpu",
        checkpoint=ck, checkpoint_every=1,
    )
    flat = telemetry.flat_counters()
    print("RESULT " + json.dumps({
        **{k: int(v) for k, v in out.items()},
        "skipped": flat.get("checkpoint_chunks_skipped", 0),
        "decodes": flat.get("ingest_chunks{stage=decode}", 0),
    }))
    """
)


def test_resume_in_a_fresh_interpreter(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    _write_int_shards(data, shards=6, rows=64)
    ck = tmp_path / "ck"
    plain = _stream(_monoid_fetches(), tft.stream_dataset(str(data)), _FEED)
    with chaos.inject_stage(stage="decode", nth=[6], fault="hang", delay_s=30.0):
        with pytest.raises(tft.DeadlineExceeded) as ei:
            _stream(_monoid_fetches(), tft.stream_dataset(str(data)), _FEED,
                    checkpoint=str(ck), checkpoint_every=1, timeout_s=2.0)
    wm = ei.value.tfs_checkpoint_watermark
    assert wm and wm >= 1
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(data), str(ck)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    got = json.loads(line[len("RESULT "):])
    for k in ("s", "mn", "mx"):
        assert got[k] == plain[k].item(), k
    assert got["skipped"] == wm
    assert got["decodes"] <= 12 - wm
