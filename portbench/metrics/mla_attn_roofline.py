"""The attention kernel's share of its roofline at latent attention's
shape: each launch's bound (`yardstick_moe.mla_attention_bound`: scores
nope + pe deep and values v_head_dim wide over the causal pairs at 67
TFLOP/s, against q, k, v and o bytes at their own widths, whatever the
kernel pads) times the launches, over the summed device time of the kernel
in the trace (by name), in %. The launches in the trace must equal the
program's ``flash_attention.*`` counters over the window and the launches a
call times the calls. None where the trace holds no launch of it."""

from portbench.yardstick_moe import mla_attention_bound

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
        raise RuntimeError(f"mla_attn_roofline: {launches} kernel launches in the trace, "
                           f"{counted} counted by the program")
    (bh, s, d_qk, d_v, causal), per_call = run.work["mla"]
    if launches != per_call * run.calls:
        raise RuntimeError(f"mla_attn_roofline: {launches} launches for {run.calls} calls "
                           f"of {per_call}")
    bound_ms, _ = mla_attention_bound(bh, s, d_qk, d_v, causal)
    return 100.0 * launches * bound_ms / 1e3 / sum(k["seconds"] for k in found.values())
