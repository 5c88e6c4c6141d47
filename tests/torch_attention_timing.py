"""Time the flash-attention kernel's entries at the LM's shape on the card.

    python3 tests/torch_attention_timing.py [--shape BHxSxD[,BHxSxD ...]]
        [--dtype DTYPE[,DTYPE ...]] [ROUNDS [ENTRY ...]]

Builds the attention kernel of the dtype (`tensorframes_tpu_torch/csrc/`) of
the checkout it runs from, then times `flash_attention` (and
`flash_attention_lse`, where the checkout has it) at BH 32, S 2048, D 64
(or the ``--shape`` given, e.g. ``16x2048x128``), causal, in ``--dtype``
``float32`` (the default), ``bfloat16`` or ``float16``; given lists, at
every shape in every dtype, one after the other in one process: ROUNDS rounds
(default 11), each the mean of 20 launches between CUDA events after a
warm-up, with the stream held by a spin kernel while the host queues
them (so a kernel shorter than the wrapper's host work is timed on the
device, not paced by the host), the entries in turns within a round. Naming entries times only
those, so that checkouts with and without an entry run the same loop. Prints one JSON line a
shape and dtype: the card's name and power limit, the medians and quartiles in ms. Run it from
the roots of two checkouts in turns (parent, change, change, parent) in one
call to compare their kernels on one card. Not collected by pytest.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000 * iters)  # ~0.5 ms of clock cycles a call
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from tensorframes_tpu_torch.ops import flash_attention as fa

    args = sys.argv[1:]
    shapes = [[32, 2048, 64]]
    dtypes = [torch.float32]
    names = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
    while args[:1] in (["--shape"], ["--dtype"]):
        if args[0] == "--shape":
            shapes = [[int(n) for n in shape.split("x")] for shape in args[1].split(",")]
        else:
            dtypes = [names[name] for name in args[1].split(",")]
        args = args[2:]
    rounds = int(args[0]) if args else 11
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    for dtype in dtypes:
        for shape in shapes:
            _time_shape(fa, card, shape, dtype, rounds, args[1:])
    return 0


def _time_shape(fa, card: str, shape, dtype, rounds: int, only) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(*shape, device="cuda", generator=gen).to(dtype) for _ in range(3))
    entries = {"flash_attention": lambda: fa.flash_attention(q, k, v, causal=True)}
    if hasattr(fa, "flash_attention_lse"):
        entries["flash_attention_lse"] = lambda: fa.flash_attention_lse(q, k, v, causal=True)
    if only:
        entries = {name: entries[name] for name in only}
    times = {name: [] for name in entries}
    for r in range(rounds):
        order = list(entries) if r % 2 == 0 else list(reversed(entries))
        for name in order:
            times[name].append(_time_ms(entries[name]))
    print(json.dumps({
        "card": card, "shape": shape, "dtype": str(dtype).replace("torch.", ""),
        "causal": True, "rounds": rounds,
        "median_ms": {n: float(np.median(t)) for n, t in times.items()},
        "quartiles_ms": {n: [float(np.percentile(t, 25)), float(np.percentile(t, 75))]
                         for n, t in times.items()},
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
