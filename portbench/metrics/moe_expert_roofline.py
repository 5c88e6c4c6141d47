"""The routed experts' share of their float32 roofline: the pairs the
program computed in the window (its ``moe.routed_pairs`` counter) times a
pair's SwiGLU operations (2 · 3 · d · h, `yardstick_moe`), over the summed
device seconds of the window calls' ``moe.experts`` spans at 67 TFLOP/s, in
%. None where the program has no such counter or span."""

from portbench.metrics.moe_route_ms import per_call_seconds
from portbench.yardstick import PEAKS


def read(run):
    pairs = run.counters.get("moe.routed_pairs")
    if not pairs:
        return None
    per_call = per_call_seconds(run, ("moe.experts",))
    if per_call is None:
        return None
    flops = pairs * run.work["expert_flops_per_pair"]
    return 100.0 * flops / (sum(per_call) * PEAKS["float32_flops"])
