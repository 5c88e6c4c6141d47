"""The dense products' share of their float32 roofline: their operations
in the traced window (counted from shapes) over the summed device time of
the GEMM kernels in the trace at 67 TFLOP/s, in %. None where the trace
holds no GEMM kernel."""

from portbench.yardstick import PEAKS


def _is_gemm(name: str) -> bool:
    n = name.lower()
    return ("gemm" in n or "splitkreduce" in n) and "flash_attention" not in n


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds = sum(k["seconds"] for n, k in t["kernels"].items() if _is_gemm(n))
    if seconds <= 0:
        return None
    return 100.0 * run.work["gemm_flops"] * run.calls / (seconds * PEAKS["float32_flops"])
