"""The precision controls of the DeepSeek-V2 scoring cells, and the probe
that sets their tie gap.

    python3 -m portbench.control_mla_moe --workload <name> --seeds 1,2,3 \\
        [--controls tf32,bf16_router,bf16_experts,renormalized,no_shared]
    python3 -m portbench.control_mla_moe --workload <name> --seeds 1,2,3 --probe

A control is the plain reference (`portbench.reference.deepseek_v2`) put in
the program's place with one departure, its logits for every frame the
window goes round handed to the cell's own comparison (the driver's
``compare``, as a run's check hands it the window's outputs); a sound limit
makes each come out not correct. One line a seed and control: the compared
numbers beside the cell's limits, and ``correct``.

- ``tf32``: the reference with TF32 on, the precision just below float32;
- ``bf16_router``: the router's product (the gate logits) in bfloat16, a
  fault whose only trace in the logits may be the experts it picks;
- ``bf16_experts``: the routed experts' three products in bfloat16;
- ``renormalized``: each token's top-k weights renormalised to sum to 1;
- ``no_shared``: the shared experts left out.

``--probe`` runs the program (`DeepSeekV2LM`, one block of sequences at a
time, as the cell's ``map_blocks`` does) and the float32 reference on frame
0 of each seed with the same weights, the reference following the program's
experts, and prints for each MoE layer the largest gap between the two gate
logits (``gap``) and the token-layers at which the program's experts differ
from the reference's own pick: the tie gap is set well above the largest
gap.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

import torch

from portbench import harness
from portbench.drivers import fn_map_blocks_mla_moe as drv
from portbench.reference import deepseek_v2 as reference

CONTROLS = {
    "tf32": ({"tf32": True}, {}),
    "bf16_router": ({}, {"router_dtype": torch.bfloat16}),
    "bf16_experts": ({}, {"experts_dtype": torch.bfloat16}),
    "renormalized": ({}, {"renormalize": True}),
    "no_shared": ({}, {"shared": False}),
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


def _capture(module, name: str, into: List[torch.Tensor], pick):
    """Wrap ``module.name`` (a router) so that each call's gate logits,
    ``pick(args, result)``, are appended to ``into``; returns the restorer."""
    orig = getattr(module, name)

    def wrapped(*args, **kw):
        res = orig(*args, **kw)
        into.append(pick(args, res).detach().clone())
        return res

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, orig)


def probe(root: Path, workload: str, seed: int, device) -> Dict:
    """Gate-logit gaps, program against reference, at every MoE layer of
    frame 0 of ``seed``, the reference following the program's experts
    everywhere (so that both compute on the same routing), with the
    token-layers where the program's experts differ from the reference's
    own pick and the reference's boundary gap (k-th minus (k+1)-th logit)
    there, and the share of tokens the tie band would flag at several gaps."""
    from tensorframes_tpu_torch.models import DeepSeekV2LM, moe

    cell = harness.resolve(root, workload)
    cfg, traffic = cell.config, cell.traffic
    k, layers = cfg["num_experts_per_tok"], drv.moe_layers(cfg)
    weights = drv.make_weights(cfg, seed, device)
    tokens = drv.make_tokens(cfg, traffic, seed, 0, device)
    block = traffic["sequences"] // traffic["blocks"]
    model = DeepSeekV2LM(cfg, weights)
    prog_logits: List[torch.Tensor] = []
    experts = []
    undo = _capture(moe, "route", prog_logits, lambda args, res: args[0])
    try:
        with torch.no_grad():
            for lo in range(0, tokens.shape[0], block):
                experts.append(model(tokens[lo:lo + block], routing=True)[1])
    finally:
        undo()
    del model
    ref_logits: List[torch.Tensor] = []
    undo = _capture(reference, "route", ref_logits, lambda args, res: res[2])
    try:
        with reference.matmul_precision(tf32=False):
            for j, lo in enumerate(range(0, tokens.shape[0], block)):
                reference.forward(weights, tokens[lo:lo + block], cfg, tie_gap=float("inf"),
                                  follow=experts[j])
    finally:
        undo()
    del weights
    experts = torch.cat(experts)  # (B, S, layers, k)
    # captured block by block: (blocks x layers) -> per layer, all tokens
    prog = [torch.cat(prog_logits[i::layers]) for i in range(layers)]
    ref = [torch.cat(ref_logits[i::layers]) for i in range(layers)]
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
              for t in (1e-5, 1e-4, 2.5e-4, 1e-3, 3e-3)}
    return {"workload": workload, "seed": seed,
            "gap": max(x["gap"] for x in rows),
            "routed_differently": sum(x["routed_differently"] for x in rows),
            "tied_share_at": shares, "layers": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control_mla_moe")
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
