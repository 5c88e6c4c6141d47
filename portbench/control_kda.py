"""The precision controls of the Kimi-Linear scoring cell, and the probe that
sets its tie gap.

    python3 -m portbench.control_kda --workload <name> --seeds 1,2,3 \\
        [--controls tf32,bf16_state,no_delta,no_conv]
    python3 -m portbench.control_kda --workload <name> --seeds 1,2,3 --probe

A control is the plain reference (`portbench.reference.kimi_linear`) put in
the program's place with one departure, its logits for every frame the
window goes round handed to the cell's own comparison (the driver's
``compare``, as a run's check hands it the window's outputs); a sound limit
makes each come out not correct. One line a seed and control: the compared
numbers beside the cell's limits, and ``correct``.

- ``tf32``: the reference with TF32 on, the precision just below float32;
- ``bf16_state``: the KDA state rounded to bfloat16 after every token;
- ``no_delta``: the delta correction dropped (u_t = v_t);
- ``no_conv``: the short convolution left out.

``--probe`` runs the program (`KimiLinearLM`, one block of sequences at a
time, as the cell's ``map_blocks`` does) and the float32 reference on frame
0 of each seed with the same weights, the reference following the program's
experts everywhere, and prints for each MoE layer the largest gap between
the two sides' selection scores (``gap``) and the token-layers at which the
program's experts differ from the reference's own pick: the tie gap is set
well above the largest gap.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

import torch

from portbench import harness
from portbench.drivers import fn_map_blocks_kda_moe as drv
from portbench.reference import kimi_linear as reference

CONTROLS = {
    "tf32": ({"tf32": True}, {}),
    "bf16_state": ({}, {"state_dtype": torch.bfloat16}),
    "no_delta": ({}, {"delta": False}),
    "no_conv": ({}, {"conv": False}),
}


def control(cell: harness.Cell, seed: int, device, name: str) -> List[harness.Compared]:
    """The control ``name`` of ``cell`` at ``seed`` through the cell's own
    comparison."""
    cfg, traffic = cell.config, cell.traffic
    precision, departure = CONTROLS[name]
    weights = drv.make_weights(cfg, seed, device)
    kept = []
    with reference.matmul_precision(tf32=precision.get("tf32", False)):
        for f in range(traffic["frames"]):
            tokens = drv.make_tokens(cfg, traffic, seed, f, device)
            parts = list(reference.forward_blocks(weights, tokens, cfg, traffic["check_block"],
                                                  **departure))
            kept.append((f, torch.cat([p[0] for p in parts]), torch.cat([p[3] for p in parts])))
            del parts
    del weights
    pairs = drv.work(cfg, traffic)["routed_pairs"] * len(kept)
    return drv.compare(cfg, traffic, seed, device, kept, cell.limits, (pairs, pairs))


def readings(root: Path, workload: str, seeds: List[int], device,
             names=tuple(CONTROLS)) -> List[Dict]:
    cell = harness.resolve(root, workload)
    out = []
    for seed in seeds:
        for name in names:
            compared = control(cell, seed, device, name)
            out.append({"workload": workload, "seed": seed, "control": name,
                        "compared": {x.name: {"value": x.value, "limit": x.limit, "ok": x.ok}
                                     for x in compared},
                        "correct": harness.correct(compared)})
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return out


def probe(root: Path, workload: str, seed: int, device) -> Dict:
    """Selection-score gaps, program against reference, at every MoE layer
    of frame 0 of ``seed``, the reference following the program's experts
    everywhere (so that both compute on the same routing), with the
    token-layers where the program's experts differ from the reference's
    own pick and the reference's boundary gap (k-th minus (k+1)-th score)
    there, and the share of tokens the tie band would flag at several
    gaps."""
    from tensorframes_tpu_torch.models import KimiLinearLM, moe

    cell = harness.resolve(root, workload)
    cfg, traffic = cell.config, cell.traffic
    k, layers = cfg["num_experts_per_token"], drv.moe_layers(cfg)
    weights = drv.make_weights(cfg, seed, device)
    tokens = drv.make_tokens(cfg, traffic, seed, 0, device)
    block = traffic["sequences"] // traffic["blocks"]
    model = KimiLinearLM(cfg, weights)
    prog: List[torch.Tensor] = []  # each MoE layer's selection scores, block by block
    orig = moe.route

    def route(logits, top_k, norm=False, scaling=1.0, scoring="softmax", bias=None):
        prog.append((torch.sigmoid(logits) + bias).detach().clone())
        return orig(logits, top_k, norm, scaling, scoring, bias)

    experts = []
    moe.route = route
    try:
        with torch.no_grad():
            for lo in range(0, tokens.shape[0], block):
                experts.append(model(tokens[lo:lo + block], routing=True)[1])
    finally:
        moe.route = orig
    del model
    ref: List[torch.Tensor] = []
    orig_ref = reference.route

    def ref_route(*args):
        res = orig_ref(*args)
        ref.append(res[2].detach().clone())
        return res

    reference.route = ref_route
    try:
        with reference.matmul_precision(tf32=False):
            for j, lo in enumerate(range(0, tokens.shape[0], block)):
                reference.forward(weights, tokens[lo:lo + block], cfg, tie_gap=float("inf"),
                                  follow=experts[j])
    finally:
        reference.route = orig_ref
    del weights
    experts = torch.cat(experts)  # (B, S, layers, k)
    # captured block by block: (blocks x layers) -> per layer, all tokens
    prog = [torch.cat(prog[i::layers]) for i in range(layers)]
    ref = [torch.cat(ref[i::layers]) for i in range(layers)]
    rows, boundaries = [], []
    for i, (p, r) in enumerate(zip(prog, ref)):
        top = r.topk(k + 1, dim=-1)
        boundary = top.values[:, k - 1] - top.values[:, k]
        boundaries.append(boundary)
        own = top.indices[:, :k].sort(dim=-1).values
        theirs = experts[:, :, i].reshape(-1, k).sort(dim=-1).values
        differ = (own != theirs).any(dim=-1)
        rows.append({"layer": i + cfg["first_k_dense_replace"],
                     "gap": float((p - r).abs().amax()),
                     "routed_differently": int(differ.sum()),
                     "widest_boundary_where_different": (float(boundary[differ].max())
                                                         if bool(differ.any()) else None)})
    boundary = torch.stack(boundaries)  # (layers, tokens)
    shares = {str(t): float((boundary < t).any(dim=0).float().mean())
              for t in (1e-6, 1e-5, 3e-5, 1e-4, 3e-4, 1e-3)}
    return {"workload": workload, "seed": seed,
            "gap": max(x["gap"] for x in rows),
            "routed_differently": sum(x["routed_differently"] for x in rows),
            "tied_share_at": shares, "layers": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control_kda")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default=",".join(CONTROLS))
    p.add_argument("--probe", action="store_true")
    args = p.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.probe:
        for seed in seeds:
            print(json.dumps(probe(harness.PKG.parent, args.workload, seed, device)), flush=True)
        return 0
    for rec in readings(harness.PKG.parent, args.workload, seeds, device,
                        args.controls.split(",")):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
