"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell's
configuration, traffic, driver, metric readers and limits are found by
name (`portbench.harness`). The run sets up the cell and warms every shape
it uses (``setup_s``, from the process's start), runs a closed loop of
calls for ``--seconds``, then checks what the window's calls returned
against the plain reference, and prints each compared number beside its
limit on standard error and the result as the last line of standard
output. With ``--trace 1`` the window runs under `torch.profiler` and the
line holds the per-layer metrics and the breakdown instead of the
end-to-end ones.

It measures `tensorframes_tpu_torch` on NVIDIA cards: without CUDA, or
with fewer cards than the cell asks for, it prints no result and exits 2.
A cell on several cards runs one process a card; this process is rank 0
and starts the others. No process of the run may load JAX or the JAX
package: a run that finds one loaded exits 3 without a result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import harness  # noqa: E402

_AGE0 = harness.process_age_s()
ROOT = harness.PKG.parent
_RANK_TIMEOUT_S = 300.0


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by rank 0 for the ranks it starts
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds."""
    base = root / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(argv, world: int, port: int, module: str, root: Path):
    """Ranks 1..world-1 of a run, each ``python -m module argv --rank r``
    from ``root``, their standard error the run's."""
    procs = []
    for r in range(1, world):
        env = dict(os.environ, LOCAL_RANK=str(r), RANK=str(r), WORLD_SIZE=str(world))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--rank", str(r), "--port", str(port)],
            cwd=str(root), env=env, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL))
    return procs


def stop_ranks(procs, timeout_s: float = _RANK_TIMEOUT_S) -> int:
    """Wait for every rank to end (killing those past ``timeout_s``); the
    first non-zero exit code, else 0."""
    rc = 0
    deadline = time.monotonic() + timeout_s
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        rc = rc or p.returncode
    return rc


def main(argv=None, device_type: str = "cuda", rank_module: str = "portbench.run",
         root: Path = ROOT) -> int:
    """One run; ``device_type`` "cpu" (gloo across ranks) and ``rank_module``
    are for the tests, which run cells on the CPU."""
    args = _parser().parse_args(argv)
    argv = list(sys.argv[1:] if argv is None else argv)
    cell = harness.resolve(root, args.workload)
    cache_dirs(root)
    if cell.chips > 1:
        # one intra-op thread a rank, as torchrun sets for several processes
        # a host: the ranks' thread pools would otherwise oversubscribe it
        os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    if device_type == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < cell.chips):
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    world = cell.chips
    device = torch.device(device_type, args.rank) if device_type == "cuda" else torch.device("cpu")
    procs = []
    port = args.port
    if world > 1 and args.rank == 0:
        port = free_port()
        procs = start_ranks(argv, world, port, rank_module, root)
    try:
        line, compared = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                                          _T0, _AGE0, args.rank, world, port)
    except BaseException:
        for p in procs:  # the others would wait on this rank's collectives
            p.kill()
        raise
    finally:
        rc = stop_ranks(procs)
    if rc:
        print(f"portbench: a rank exited {rc}", file=sys.stderr)
        return rc
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}, which the port must not use", file=sys.stderr)
        return 3
    if line is not None:
        harness.report(line, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
