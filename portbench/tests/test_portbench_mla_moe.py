"""The DeepSeek-V2 scoring cell at a tiny size on the CPU, in a checkout of
its own: a run through the benchmark's machinery comes out ``correct``, and
not correct for every fault its timed path can have (a logit altered, the
top-k weights renormalised, the shared experts skipped, half a block's
sequences scored, a token sent to the wrong experts); the precision
controls fail the cell's own comparison; the new readers read the tiny
traced run's spans; the reference agrees with the program and the
arithmetic matches the published widths. The controls at the cell's own
sizes run on the card (``-m card``)."""

from __future__ import annotations

import json
import math
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench import control_mla_moe, harness, yardstick_moe
from portbench.drivers import fn_map_blocks_mla_moe as drv
from portbench.reference import deepseek_v2 as reference
from portbench.tests import tiny

CELL = "dsv2lite.score.s1024"
TINY_CELL = "dsv2lite.tiny"
CONFIG = json.loads((tiny.REPO / "portbench" / "configs" / "deepseek-v2-lite.json").read_text())
TINY = dict(
    CONFIG, name="dsv2-tiny", hidden_size=64, vocab_size=97, num_hidden_layers=3,
    num_attention_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    kv_lora_rank=32, intermediate_size=96, moe_intermediate_size=24, n_routed_experts=8,
    num_experts_per_tok=2, n_shared_experts=2, first_k_dense_replace=1,
    # 0.02 * sqrt(2048 / 64): the published model's activation sizes at width 64
    initializer_range=0.113,
)
TRAFFIC = dict(json.loads((tiny.REPO / "portbench" / "traffic" / "score.zipf.s1024.json")
                          .read_text()), sequences=4, seq_len=24, warmup_calls=1)
SEED = 3000000019
CPU = torch.device("cpu")


def make_checkout(tmp: Path) -> Path:
    """``tmp`` holding the benchmark with the tiny cell added as data: the
    new cell's driver, limits and per-layer metrics at a tiny size."""
    shutil.copytree(tiny.REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    pkg = tmp / "portbench"
    (pkg / "configs" / "dsv2-tiny.json").write_text(json.dumps(TINY))
    bench["configs"].append({"name": "dsv2-tiny", "source": "tiny",
                             "file": "portbench/configs/dsv2-tiny.json", "reduced": [],
                             "why": "CPU test"})
    (pkg / "traffic" / "score.zipf.tiny.json").write_text(json.dumps(TRAFFIC))
    shutil.copy(pkg / "limits" / f"{CELL}.json", pkg / "limits" / f"{TINY_CELL}.json")
    bench["workloads"].append({"name": TINY_CELL, "config": "dsv2-tiny",
                               "traffic": "score.zipf.tiny", "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY_CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("checkout"))


def _run(root, trace=False, seconds=0.3):
    cell = harness.resolve(root, TINY_CELL)
    return harness.run_cell(cell, SEED, seconds, trace, CPU, time.perf_counter(), 0.0)[0]


# --- faults planted under the timed path ------------------------------------

def _logit_altered(mp):
    from tensorframes_tpu_torch.models import DeepSeekV2LM

    orig = DeepSeekV2LM.forward

    def forward(self, tokens, routing=False):
        out = orig(self, tokens, routing)
        (out[0] if routing else out)[0, 0, 0] += 1.0
        return out

    mp.setattr(DeepSeekV2LM, "forward", forward)


def _renormalized(mp):
    from tensorframes_tpu_torch.models import moe

    orig = moe.route
    mp.setattr(moe, "route", lambda logits, k, norm=False, scaling=1.0: orig(logits, k, True,
                                                                              scaling))


def _no_shared(mp):
    from tensorframes_tpu_torch.models import DeepSeekV2LM

    mp.setattr(DeepSeekV2LM, "shared_experts", lambda self, i, x: torch.zeros_like(x))


def _half_batch(mp):
    from tensorframes_tpu_torch.models import DeepSeekV2LM

    orig = DeepSeekV2LM.forward

    def forward(self, tokens, routing=False):
        half = max(1, tokens.shape[0] // 2)
        reps, rest = tokens.shape[0] // half, tokens.shape[0] % half
        outs = orig(self, tokens[:half], routing)
        grow = lambda t: torch.cat([t] * reps + [t[:rest]])  # noqa: E731
        return tuple(map(grow, outs)) if routing else grow(outs)

    mp.setattr(DeepSeekV2LM, "forward", forward)


def _wrong_experts(mp):
    """Each block's first token sent to its k least likely experts."""
    from tensorframes_tpu_torch.models import moe

    orig = moe.route

    def route(logits, k, *a):
        weights, experts = orig(logits, k, *a)
        experts[0] = logits[0].topk(k, largest=False).indices
        return weights, experts

    mp.setattr(moe, "route", route)


FAULTS = {"logit_altered": _logit_altered, "renormalized": _renormalized,
          "no_shared": _no_shared, "half_batch": _half_batch, "wrong_experts": _wrong_experts}


def test_the_tiny_cell_is_correct(root):
    line = _run(root)
    assert line["correct"] is True, line["compared"]
    assert set(line["compared"]) == {"logits_max_abs_err", "routing_wrong",
                                     "tied_token_share", "routed_pairs_wrong"}
    assert line["compared"]["routed_pairs_wrong"]["value"] == 0
    assert line["attempted"] > 0 and set(line["metrics"]) == {"tokens_per_s", "call_p95_ms",
                                                                "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_under_the_timed_path_is_caught(root, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    line = _run(root)
    assert line["correct"] is False, (fault, line["compared"])
    err = line["compared"]["logits_max_abs_err"]
    assert err["value"] > err["limit"]
    if fault == "wrong_experts":
        assert line["compared"]["routing_wrong"]["value"] > 0


def test_a_lost_routed_pair_is_caught(root, monkeypatch):
    from tensorframes_tpu_torch.models import moe

    orig = moe._count
    monkeypatch.setattr(moe, "_count", lambda key, value=1.0: orig(
        key, value - (key == "moe.routed_pairs")))
    line = _run(root)
    assert line["correct"] is False
    assert line["compared"]["routed_pairs_wrong"]["value"] > 0


@pytest.mark.parametrize("name", ["bf16_router", "bf16_experts", "renormalized", "no_shared"])
def test_the_controls_fail_the_cells_own_comparison(root, name):
    (rec,) = control_mla_moe.readings(root, TINY_CELL, [2**31 + 17], CPU, [name])
    assert rec["correct"] is False, rec
    assert not rec["compared"]["logits_max_abs_err"]["ok"]


def test_the_tf32_control_goes_through_the_cells_own_comparison(root):
    # the CPU has no TF32, so here the control computes float32 and agrees;
    # on the card it fails (test_precision_controls_fail_on_the_card)
    (rec,) = control_mla_moe.readings(root, TINY_CELL, [2**31 + 19], CPU, ["tf32"])
    assert rec["compared"]["logits_max_abs_err"]["value"] < 1e-5 and rec["correct"] is True


def test_the_new_readers_read_the_traced_spans(root):
    line = _run(root, trace=True)
    assert line["correct"], line["compared"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert {"lm_mfu.moe", "moe_route_ms", "moe_expert_roofline"} <= set(m)
    assert m["moe_route_ms"] > 0 and m["moe_expert_roofline"] > 0 and m["lm_mfu.moe"] > 0
    # the CPU trace has no kernel of the card
    assert "mla_attn_roofline" not in m and m["device_idle.moe"] == 100.0


def test_the_span_readers_find_nothing_in_a_program_without_the_layer(root):
    from tensorframes_tpu_torch.utils import telemetry

    _run(root, trace=True)
    spans = telemetry.spans()
    telemetry.reset()
    for s in spans:  # the ring again, without the layer's spans
        if not s.name.startswith("moe."):
            telemetry._ring.append(s)
    run = harness.Run(1.0, 0.3, [0.01] * 2, drv.work(TINY, TRAFFIC), {"moe.routed_pairs": 9})
    for metric in ("moe_route_ms", "moe_expert_roofline"):
        reader = harness.load_module(root / "portbench" / "metrics" / f"{metric}.py", "metric")
        assert reader.read(run) is None


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_the_reference_matches_the_program(seed):
    from tensorframes_tpu_torch.models import DeepSeekV2LM

    weights = drv.make_weights(TINY, seed, CPU)
    tokens = drv.make_tokens(TINY, TRAFFIC, seed, 0, CPU)
    got = DeepSeekV2LM(TINY, weights)(tokens)
    want, tied, _, _ = reference.forward(weights, tokens, TINY, tie_gap=1e-4)
    assert got.shape == (4, 24, 97) and float(tied.float().mean()) < 0.05
    # logits of order 1 after float32 sums in other orders: ~80 ulp of room
    torch.testing.assert_close(got[~tied], want[~tied], rtol=1e-5, atol=1e-5)


def test_weights_and_tokens_follow_the_seed():
    a, b = drv.make_weights(TINY, 9, CPU), drv.make_weights(TINY, 9, CPU)
    c = drv.make_weights(TINY, 10, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert a["l1_experts_gate_up"].std().item() == pytest.approx(0.113, rel=0.1)
    assert torch.equal(a["norm"], torch.ones(64))
    t = drv.make_tokens(TINY, dict(TRAFFIC, sequences=64), 2**31 + 5, 0, CPU)
    assert torch.equal(t, drv.make_tokens(TINY, dict(TRAFFIC, sequences=64), 2**31 + 5, 0, CPU))
    assert int(t.min()) >= 0 and int(t.max()) < 97
    # Zipf: the commonest id is about 1 / H(V, 1.1) of the tokens
    h = sum(r ** -1.1 for r in range(1, 98))
    assert torch.bincount(t.flatten()).max().item() / t.numel() == pytest.approx(1 / h, rel=0.15)


def test_the_driver_draws_the_programs_weight_layout():
    from tensorframes_tpu_torch.models import DeepSeekV2LM
    from tensorframes_tpu_torch.models.deepseek_v2 import weight_shapes

    w = drv.make_weights(TINY, 4, CPU)
    assert {k: tuple(t.shape) for k, t in w.items()} == weight_shapes(TINY)
    # views of one buffer, in the order they are drawn, taken without a copy
    base = w["embed"].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in w.values())
    model = DeepSeekV2LM(TINY, w)
    assert all(model.params[k].data_ptr() == t.data_ptr() for k, t in w.items())
    assert weight_shapes(CONFIG)["l1_experts_gate_up"] == (64, 2048, 2 * 1408)
    n = sum(math.prod(s) for s in weight_shapes(CONFIG).values())
    assert n == 15_706_484_224  # 62.8 GB in float32


def test_the_flop_count_at_the_published_widths():
    p = yardstick_moe.flops_per_token(CONFIG, 1024)
    assert p["total"] == 5_044_313_088
    assert p["routed_experts"] == 26 * 6 * 2 * 3 * 2048 * 1408
    assert p["attention"] == 27 * 2 * 16 * (192 + 128) * 1025 / 2
    w = drv.work(CONFIG, json.loads((tiny.REPO / "portbench" / "traffic"
                                     / "score.zipf.s1024.json").read_text()))
    assert w["routed_pairs"] == 4096 * 6 * 26 and w["mla"] == [(32, 1024, 192, 128, True), 54]


def test_the_mla_attention_bound():
    ms, by = yardstick_moe.mla_attention_bound(32, 1024, 192, 128, True)
    assert by == "operations"
    assert ms == pytest.approx(2 * 320 * 1024 * 1025 / 2 * 32 / 67e12 * 1e3)
    ms, by = yardstick_moe.mla_attention_bound(1, 1, 192, 128, True)
    assert by == "bytes" and ms == pytest.approx(2 * 320 * 4 / 3.35e12 * 1e3)


def test_the_reference_copies_are_identical():
    assert ((tiny.REPO / "tests" / "plain_deepseek_v2.py").read_bytes()
            == (tiny.REPO / "portbench" / "reference" / "deepseek_v2.py").read_bytes())


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(control_mla_moe.CONTROLS))
def test_precision_controls_fail_on_the_card(card, name):
    for rec in control_mla_moe.readings(tiny.REPO, CELL, [2**31 + 101, 2**31 + 103], card,
                                        [name]):
        print(rec)
        assert rec["correct"] is False, rec


def test_the_tie_gap_probe_reads_rounding_gaps(root):
    rec = control_mla_moe.probe(root, TINY_CELL, 2**31 + 23, CPU)
    assert len(rec["layers"]) == TINY["num_hidden_layers"] - 1
    assert 0 < rec["gap"] < 1e-4 and rec["routed_differently"] == 0
