"""The Kimi-Linear scoring cell at a tiny size on the CPU, in a checkout of
its own: the new cell resolves its files; a run through the benchmark's
machinery comes out ``correct``, and not correct for every fault its timed
path can have (a logit altered, a token sent to the wrong experts, the
short convolution skipped, the delta correction dropped, a miscounted
pair); the precision controls fail the cell's own comparison; the new
readers read the tiny traced run's spans, or a trace's kernel launches, and
give None without them; the reference agrees with the program and the
arithmetic matches the published widths; no module of the cell loads JAX.
The controls at the cell's own sizes run on the card (``-m card``)."""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import control_kda, harness, yardstick_kda
from portbench.drivers import fn_map_blocks_kda_moe as drv
from portbench.reference import kimi_linear as reference
from portbench.tests import tiny

CELL = "kimilinear.score.s4096"
TINY_CELL = "kimilinear.tiny"
CONFIG = json.loads((tiny.REPO / "portbench" / "configs" / "kimi-linear-48b-a3b.json")
                    .read_text())
TINY = dict(
    CONFIG, name="kimi-tiny", hidden_size=64, vocab_size=97, num_hidden_layers=5,
    num_attention_heads=4, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    kv_lora_rank=32, intermediate_size=96, moe_intermediate_size=24, num_experts=4,
    published={"num_experts": 8}, experts_held=[2, 6], num_experts_per_token=2,
    linear_attn_config={"full_attn_layers": [4], "kda_layers": [1, 2, 3, 5], "head_dim": 16,
                        "num_heads": 4, "short_conv_kernel_size": 4},
    # 0.02 * sqrt(2304 / 64): the published model's activation sizes at width 64
    initializer_range=0.12,
)
TRAFFIC = dict(json.loads((tiny.REPO / "portbench" / "traffic" / "score.zipf.s4096.json")
                          .read_text()), sequences=2, seq_len=24, blocks=2, warmup_calls=1)
SEED = 3100000019
CPU = torch.device("cpu")


def make_checkout(tmp: Path) -> Path:
    """``tmp`` holding the benchmark with the tiny cell added as data: the
    new cell's driver, limits and per-layer metrics at a tiny size."""
    shutil.copytree(tiny.REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    pkg = tmp / "portbench"
    (pkg / "configs" / "kimi-tiny.json").write_text(json.dumps(TINY))
    bench["configs"].append({"name": "kimi-tiny", "source": "tiny",
                             "file": "portbench/configs/kimi-tiny.json",
                             "reduced": ["num_experts"], "why": "CPU test"})
    (pkg / "traffic" / "score.zipf.tiny.json").write_text(json.dumps(TRAFFIC))
    shutil.copy(pkg / "limits" / f"{CELL}.json", pkg / "limits" / f"{TINY_CELL}.json")
    bench["workloads"].append({"name": TINY_CELL, "config": "kimi-tiny",
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


def test_the_new_cell_resolves_its_files():
    cell = harness.resolve(tiny.REPO, CELL)
    assert cell.driver_path.name == "fn_map_blocks_kda_moe.py" and cell.chips == 1
    assert cell.config["num_experts"] == 64 and cell.config["experts_held"] == [0, 64]
    assert set(cell.limits) == {"logits_max_abs_err", "routing_wrong", "tied_token_share",
                                "routed_pairs_wrong"}
    assert cell.end_to_end == ["tokens_per_s", "call_p95_ms", "setup_s"]
    assert {"kda_ms", "kda_roofline", "lm_mfu.moe", "device_idle.moe", "moe_expert_roofline",
            "mla_attn_roofline", "moe_route_ms", "gemm_roofline", "verb_host_ms",
            "verb_self_ms"} == set(cell.per_layer)
    assert all(m["path"].exists() for m in cell.metrics.values())


# --- faults planted under the timed path ------------------------------------

def _logit_altered(mp):
    from tensorframes_tpu_torch.models import KimiLinearLM

    orig = KimiLinearLM.forward

    def forward(self, tokens, routing=False):
        out = orig(self, tokens, routing)
        (out[0] if routing else out)[0, 0, 0] += 1.0
        return out

    mp.setattr(KimiLinearLM, "forward", forward)


def _wrong_experts(mp):
    """Each block's first token sent to its k least likely experts."""
    from tensorframes_tpu_torch.models import moe

    orig = moe.route

    def route(logits, k, *a):
        weights, experts = orig(logits, k, *a)
        experts[0] = logits[0].topk(k, largest=False).indices
        return weights, experts

    mp.setattr(moe, "route", route)


def _no_conv(mp):
    from tensorframes_tpu_torch.models import kimi_linear

    mp.setattr(kimi_linear, "_short_conv", lambda x, filters: x)


def _no_delta(mp):
    """The recurrence with u_t = v_t: S' k taken as zero."""
    from tensorframes_tpu_torch.models import kimi_linear

    def kda(q, k, g, beta, v, scale=None):
        b, s, h, d = q.shape
        state, out = q.new_zeros(b, h, d, d), torch.empty_like(v)
        for t in range(s):
            state = state * g[:, t].exp().unsqueeze(-1)
            state = state + beta[:, t, :, None, None] * k[:, t].unsqueeze(-1) * v[:, t, :, None, :]
            out[:, t] = scale * (state * q[:, t].unsqueeze(-1)).sum(-2)
        return out

    mp.setattr(kimi_linear, "kda", kda)


FAULTS = {"logit_altered": _logit_altered, "wrong_experts": _wrong_experts,
          "no_conv": _no_conv, "no_delta": _no_delta}


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
    if fault == "wrong_experts":
        assert line["compared"]["routing_wrong"]["value"] > 0
    else:
        err = line["compared"]["logits_max_abs_err"]
        assert err["value"] > err["limit"]


@pytest.mark.parametrize("counter", ["moe.routed_pairs", "moe.foreign_pairs"])
def test_a_miscounted_pair_is_caught(root, monkeypatch, counter):
    from tensorframes_tpu_torch.models import moe

    orig = moe._count
    monkeypatch.setattr(moe, "_count", lambda key, value=1.0: orig(key, value - (key == counter)))
    line = _run(root)
    assert line["correct"] is False
    assert line["compared"]["routed_pairs_wrong"]["value"] > 0


@pytest.mark.parametrize("name", ["bf16_state", "no_delta", "no_conv"])
def test_the_controls_fail_the_cells_own_comparison(root, name):
    (rec,) = control_kda.readings(root, TINY_CELL, [2**31 + 17], CPU, [name])
    assert rec["correct"] is False, rec
    assert not rec["compared"]["logits_max_abs_err"]["ok"]


def test_the_tf32_control_goes_through_the_cells_own_comparison(root):
    # the CPU has no TF32, so here the control computes float32 and agrees;
    # on the card it fails (test_precision_controls_fail_on_the_card)
    (rec,) = control_kda.readings(root, TINY_CELL, [2**31 + 19], CPU, ["tf32"])
    assert rec["compared"]["logits_max_abs_err"]["value"] < 1e-4 and rec["correct"] is True


def test_the_new_readers_read_the_traced_spans(root):
    line = _run(root, trace=True)
    assert line["correct"], line["compared"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    spans = ("kda_ms", "moe_route_ms", "verb_host_ms", "verb_self_ms")
    assert {"lm_mfu.moe", "moe_expert_roofline", *spans} <= set(m)
    assert all(m[k] > 0 for k in ("lm_mfu.moe", "moe_expert_roofline", *spans)), m
    assert m["verb_self_ms"] < m["verb_host_ms"]
    # the CPU trace has no kernel of the card
    assert not {"kda_roofline", "mla_attn_roofline", "gemm_roofline"} & set(m)
    assert m["device_idle.moe"] == 100.0


def _reader(root, metric):
    return harness.load_module(root / "portbench" / "metrics" / f"{metric}.py", "metric")


def test_the_roofline_reads_the_kernels_launches(root):
    """Two calls of the cell's 20 launches at 0.5 ms each: the bound over
    the time; a trace whose launches the program did not count raises."""
    w = drv.work(CONFIG, json.loads((tiny.REPO / "portbench" / "traffic"
                                     / "score.zipf.s4096.json").read_text()))
    trace = {"kernels": {"(anonymous namespace)::kda_kernel(float const*, ...)":
                         {"count": 40, "seconds": 40 * 0.5e-3},
                         "flash_attention_kernel": {"count": 14, "seconds": 1.0}}}
    run = harness.Run(1.0, 1.0, [0.5, 0.5], w, {"kda.launches": 40}, trace)
    bound, by = yardstick_kda.kda_bound(1, 4096, 32, 128)
    assert by == "operations"
    assert _reader(root, "kda_roofline").read(run) == pytest.approx(100 * bound / 0.5)
    run.counters["kda.launches"] = 39
    with pytest.raises(RuntimeError, match="counted by the program"):
        _reader(root, "kda_roofline").read(run)
    run.counters["kda.launches"] = 40
    run.latencies_s.append(0.5)  # three calls of 20 would need 60 launches
    with pytest.raises(RuntimeError, match="launches for 3 calls"):
        _reader(root, "kda_roofline").read(run)
    run.trace = None
    assert _reader(root, "kda_roofline").read(run) is None


def test_the_gemm_share_counts_the_products_alone(root):
    """gemm_flops is every product of the count (the recurrence and the
    attention left out), read over the GEMM kernels' time alone."""
    traffic = json.loads((tiny.REPO / "portbench" / "traffic" / "score.zipf.s4096.json")
                         .read_text())
    w = drv.work(CONFIG, traffic)
    parts = yardstick_kda.flops_per_token(CONFIG, traffic["seq_len"])
    products = ("kda_projections", "mla_projections", "dense_mlp", "router", "routed_experts",
                "shared_experts", "head")
    assert set(parts) == {*products, "kda_recurrence", "mla_attention", "total"}
    assert w["gemm_flops"] == pytest.approx(4096 * sum(parts[k] for k in products))
    trace = {"kernels": {"sm80_xmma_gemm_f32f32_f32f32_f32_nn_n": {"count": 9, "seconds": 0.2},
                         "cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>":
                         {"count": 9, "seconds": 0.1},
                         "(anonymous namespace)::kda_kernel(float const*, ...)":
                         {"count": 40, "seconds": 5.0},
                         "flash_attention_wide_kernel<false>": {"count": 14, "seconds": 5.0}}}
    run = harness.Run(1.0, 1.0, [0.5, 0.5], w, {}, trace)
    assert _reader(root, "gemm_roofline").read(run) == pytest.approx(
        100 * 2 * w["gemm_flops"] / (0.3 * 67e12))


def test_the_span_reader_finds_nothing_in_a_program_without_the_layer(root):
    from tensorframes_tpu_torch.utils import telemetry

    _run(root, trace=True)
    spans = telemetry.spans()
    telemetry.reset()
    for s in spans:  # the ring again, without the layer's spans
        if not s.name.startswith("kda."):
            telemetry._ring.append(s)
    run = harness.Run(1.0, 0.3, [0.01] * 2, drv.work(TINY, TRAFFIC), {})
    assert _reader(root, "kda_ms").read(run) is None


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_the_reference_matches_the_program(seed):
    from tensorframes_tpu_torch.models import KimiLinearLM

    weights = drv.make_weights(TINY, seed, CPU)
    tokens = drv.make_tokens(TINY, TRAFFIC, seed, 0, CPU)
    with torch.no_grad():
        got, experts = KimiLinearLM(TINY, weights)(tokens, routing=True)
    want, tied, wrong, _ = reference.forward(weights, tokens, TINY, tie_gap=1e-4, follow=experts)
    assert got.shape == (2, 24, 97) and int(wrong.sum()) == 0
    # logits of order 1 after float32 sums in other orders: ~80 ulp of room
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_weights_follow_the_seed_and_the_assumed_laws():
    a, b = drv.make_weights(TINY, 9, CPU), drv.make_weights(TINY, 9, CPU)
    c = drv.make_weights(TINY, 10, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert a["l1_experts_gate_up"].std().item() == pytest.approx(0.12, rel=0.1)
    assert torch.equal(a["norm"], torch.ones(64)) and torch.equal(a["l0_kda_o_norm"],
                                                                  torch.ones(16))
    big = drv.make_weights(dict(TINY, linear_attn_config=dict(
        TINY["linear_attn_config"], num_heads=64)), 11, CPU)
    a_log = big["l0_kda_A_log"].exp()
    assert 1.0 <= float(a_log.min()) and float(a_log.max()) <= 16.0
    dt = torch.nn.functional.softplus(big["l0_kda_dt_bias"])
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.001
    assert float(big["l0_kda_conv"].abs().max()) <= 0.5
    assert float(big["l0_kda_conv"].std()) == pytest.approx(12 ** -0.5, rel=0.1)
    bias = big["l1_router_bias"]
    assert float(bias.abs().max()) < 1e-2 and float(bias.std()) < 3e-3


def test_the_driver_draws_the_programs_weight_layout():
    from tensorframes_tpu_torch.models import KimiLinearLM
    from tensorframes_tpu_torch.models.kimi_linear import weight_shapes

    w = drv.make_weights(TINY, 4, CPU)
    assert {k: tuple(t.shape) for k, t in w.items()} == weight_shapes(TINY)
    base = w["embed"].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in w.values())
    model = KimiLinearLM(TINY, w)
    assert all(model.params[k].data_ptr() == t.data_ptr() for k, t in w.items())
    shapes = weight_shapes(CONFIG)
    assert shapes["l1_experts_gate_up"] == (64, 2304, 2 * 1024)
    assert shapes["l1_router"] == (2304, 256) and shapes["l0_kda_qkv"] == (2304, 3 * 4096)
    n = sum(math.prod(s) for s in shapes.values())
    assert n == pytest.approx(13.79e9, rel=1e-3)  # 55.2 GB in float32


def test_the_flop_count_at_the_published_widths():
    p = yardstick_kda.flops_per_token(CONFIG, 4096)
    assert p["total"] == 4_370_307_072
    assert p["routed_experts"] == 26 * 8 * 64 / 256 * 2 * 3 * 2304 * 1024
    assert p["kda_recurrence"] == 20 * 7 * 32 * 128 * 128
    assert p["mla_attention"] == 7 * 2 * 32 * (192 + 128) * 4097 / 2
    w = drv.work(CONFIG, json.loads((tiny.REPO / "portbench" / "traffic"
                                     / "score.zipf.s4096.json").read_text()))
    assert w["routed_pairs"] == 4096 * 8 * 26
    assert w["mla"] == [(32, 4096, 192, 128, True), 7]
    assert w["kda"] == [(1, 4096, 32, 128), 20]


def test_the_kda_bound():
    ms, by = yardstick_kda.kda_bound(1, 4096, 32, 128)
    assert by == "operations" and ms == pytest.approx(7 * 128 * 128 * 4096 * 32 / 67e12 * 1e3)
    assert round(ms, 3) == 0.224
    ms, by = yardstick_kda.kda_bound(1, 1, 1, 4)
    assert by == "bytes" and ms == pytest.approx(21 * 4 / 3.35e12 * 1e3)


def test_the_reference_copies_are_identical():
    assert ((tiny.REPO / "tests" / "plain_kimi_linear.py").read_bytes()
            == (tiny.REPO / "portbench" / "reference" / "kimi_linear.py").read_bytes())


def test_the_cells_modules_load_no_jax():
    code = ("import sys; import portbench.drivers.fn_map_blocks_kda_moe, portbench.control_kda, "
            "portbench.reference.kimi_linear, portbench.metrics.kda_ms, "
            "portbench.metrics.kda_roofline; "
            "import tensorframes_tpu_torch.models.kimi_linear; "
            "from portbench.harness import forbidden_modules; print(forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tiny.REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(control_kda.CONTROLS))
def test_precision_controls_fail_on_the_card(card, name):
    for rec in control_kda.readings(tiny.REPO, CELL, [2**31 + 101], card, [name]):
        print(rec)
        assert rec["correct"] is False, rec


def test_the_tie_gap_probe_reads_rounding_gaps(root):
    rec = control_kda.probe(root, TINY_CELL, 2**31 + 23, CPU)
    assert len(rec["layers"]) == TINY["num_hidden_layers"] - 1
    assert 0 < rec["gap"] < 1e-4 and rec["routed_differently"] == 0
