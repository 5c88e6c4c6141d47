"""The attention kernel's share of its roofline: each launch's bound
(`yardstick.attention_bound` at its shape: causal pairs at 67 TFLOP/s
against q, k, v, o bytes at 3.35 TB/s) times the launches, over the summed
device time of the kernel in the trace (by name), in %. The launches in the
trace must equal the program's ``launches_by_route`` count over the window.
None where the trace holds no launch of it."""

from portbench.yardstick import attention_bound

_KERNEL = "flash_attention"


def read(run):
    t = run.trace
    if t is None:
        return None
    found = {n: k for n, k in t["kernels"].items() if _KERNEL in n}
    launches = sum(k["count"] for k in found.values())
    if launches == 0:
        return None
    counted = sum(v for k, v in run.counters.items() if k.startswith("flash_attention."))
    if launches != counted:
        raise RuntimeError(f"attn_roofline: {launches} kernel launches in the trace, "
                           f"{counted} counted by the program")
    (bh, s, d, causal), per_call = run.work["attention"]
    if launches != per_call * run.calls:
        raise RuntimeError(f"attn_roofline: {launches} launches for {run.calls} calls "
                           f"of {per_call}")
    bound_ms, _ = attention_bound(bh, s, d, causal)
    return 100.0 * launches * bound_ms / 1e3 / sum(k["seconds"] for k in found.values())
