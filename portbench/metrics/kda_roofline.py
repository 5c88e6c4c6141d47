"""The KDA recurrence kernel's share of its roofline: each launch's bound
(`yardstick_kda.kda_bound` at its shape: 7 operations a state element a
token-head at 67 TFLOP/s, against q, k, g, v, o and beta moved once at
3.35 TB/s) times the launches, over the summed device time of the kernel in
the trace (by name), in %. The launches in the trace must equal the
program's ``kda.launches`` counter over the window and the launches a call
times the calls. None where the trace holds no launch of it."""

from portbench.yardstick_kda import kda_bound

_KERNEL = "kda_kernel"


def read(run):
    t = run.trace
    if t is None:
        return None
    found = {n: k for n, k in t["kernels"].items() if _KERNEL in n}
    launches = sum(k["count"] for k in found.values())
    if launches == 0:
        return None
    counted = run.counters.get("kda.launches", 0)
    if launches != counted:
        raise RuntimeError(f"kda_roofline: {launches} kernel launches in the trace, "
                           f"{counted} counted by the program")
    (b, s, h, d), per_call = run.work["kda"]
    if launches != per_call * run.calls:
        raise RuntimeError(f"kda_roofline: {launches} launches for {run.calls} calls "
                           f"of {per_call}")
    bound_ms, _ = kda_bound(b, s, h, d)
    return 100.0 * launches * bound_ms / 1e3 / sum(k["seconds"] for k in found.values())
