"""PyTorch port: the KDA recurrence kernel of ``csrc/kda.cu`` against its
plain version on an NVIDIA card (`ops.kda`).

Every case draws q and k L2-normalised per head, a log-decay g, beta in
(0, 1) and v, runs `kda` on the card (one launch of the kernel) and holds it
to `kda_reference` on the same tensors on the card and in float64. Cases:
S 1, 64 and 4,096 at H 1 to 32 and B 1 to 2; decays near 0 (g -30) and near
1 (g -1e-6); S not a multiple of the kernel's 8-token stages; the kernel
against the CPU's plain version at small S; misaligned and strided inputs;
what ptxas said of the library built afresh; and that importing the port
builds no library (the kernel is built at its first use).

Tolerance: rtol 1e-4, atol 2e-5 against the float32 plain version and
float64. Both sides compute in float32; they sum a step's 128 products in
other orders (the kernel in 8 threads of 16 rows, then a shuffle tree), and
the kernel takes o as scale * (S'^T q + beta u (k . q)), the same value
rounded otherwise. The state forgets an error at the rate it forgets
anything, so errors stay at a few units in the last place of the state's
size (values of order 1) however long the sequence.

This file imports no JAX, so the card's machine runs it without the
repository's conftest:

    python3 -m pytest tests/test_torch_kda_card.py -m card --noconftest -p no:cacheprovider -q
"""

import re
import subprocess
import sys

import pytest
import torch

from tensorframes_tpu_torch.ops.kda import kda, kda_reference

from _torch_card import build_logs_afresh
from _torch_card import card  # noqa: F401 - the fixture

_RTOL, _ATOL = 1e-4, 2e-5


def _inputs(b, s, h, device, seed, g_range=(-3.0, -1e-3)):
    """q, k unit per head; g uniform in log space over ``g_range`` (both
    negative); beta in (0, 1); v normal."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    q = torch.nn.functional.normalize(draw(b, s, h, 128), dim=-1)
    k = torch.nn.functional.normalize(draw(b, s, h, 128), dim=-1)
    lo, hi = (torch.log(torch.tensor(-x)) for x in g_range)
    u = torch.rand(b, s, h, 128, generator=gen, device=device)
    g = -torch.exp(hi + (lo - hi) * u)
    beta = torch.rand(b, s, h, generator=gen, device=device)
    v = draw(b, s, h, 128)
    return q, k, g, beta, v


def _check(card, args, seed_msg):
    before = kda.launches
    got = kda(*args)
    torch.cuda.synchronize()
    assert kda.launches == before + 1
    assert got.shape == args[0].shape and got.dtype == torch.float32 and got.device == card
    want = kda_reference(*args)
    torch.testing.assert_close(got, want, rtol=_RTOL, atol=_ATOL, msg=seed_msg)
    want64 = kda_reference(*(t.double() for t in args))
    torch.testing.assert_close(got.double(), want64, rtol=_RTOL, atol=_ATOL, msg=seed_msg)


_SHAPES = [(1, 1, 1), (2, 1, 32), (1, 64, 1), (2, 64, 7), (1, 64, 32), (1, 67, 3), (2, 13, 5),
           (1, 4096, 32), (2, 4096, 1)]


@pytest.mark.card
@pytest.mark.parametrize("b,s,h", _SHAPES, ids=[f"b{b}-s{s}-h{h}" for b, s, h in _SHAPES])
def test_kernel_matches_the_plain_version(card, b, s, h):
    _check(card, _inputs(b, s, h, card, seed=2**31 + 100 * s + h), f"b{b} s{s} h{h}")


@pytest.mark.card
@pytest.mark.parametrize("g_range", [(-30.0, -20.0), (-1e-6, -1e-7), (-30.0, -1e-7)],
                         ids=["decay-near-0", "decay-near-1", "both"])
def test_decays_near_zero_and_one(card, g_range):
    _check(card, _inputs(2, 300, 4, card, seed=2**31 + 7, g_range=g_range), str(g_range))


@pytest.mark.card
@pytest.mark.parametrize("s", [1, 5, 17])
def test_kernel_matches_the_cpu_plain_version(card, s):
    args = _inputs(2, s, 3, card, seed=2**31 + s)
    got = kda(*args).cpu()
    want = kda(*(t.cpu() for t in args))
    torch.testing.assert_close(got, want, rtol=_RTOL, atol=_ATOL)


@pytest.mark.card
def test_misaligned_and_strided_inputs(card):
    q, k, g, beta, v = _inputs(1, 40, 2, card, seed=2**31 + 41)
    buf = torch.zeros(q.numel() + 1, device=card)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16 != 0
    wide = torch.stack([v, v], -1).reshape(1, 40, 2, 256)[..., ::2]
    assert not wide.is_contiguous()
    torch.testing.assert_close(kda(shifted, k, g, beta, wide), kda(q, k, g, beta, v),
                               rtol=0, atol=0)


@pytest.mark.card
def test_shapes_the_kernel_refuses(card):
    q, k, g, beta, v = _inputs(1, 8, 2, card, seed=3)
    with pytest.raises(ValueError, match="share one"):
        kda(q, k[:, :4], g, beta, v)
    with pytest.raises(ValueError, match="no kernel for D 64"):
        kda(q[..., :64], k[..., :64], g[..., :64], beta, v[..., :64])
    with pytest.raises(ValueError, match="beta"):
        kda(q, k, g, beta[:, :4], v)
    with pytest.raises(ValueError, match="device"):
        kda(q, k.cpu(), g, beta, v)


@pytest.mark.card
def test_ptxas_spills_nothing(card, tmp_path):
    """What ptxas said of the library built afresh: the kernel compiled
    without a register spill."""
    log = build_logs_afresh(["kda"], tmp_path)["kda"]
    found = re.findall(r"Compiling entry function '\w*kda_kernel\w*'.*?(\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads.*?Used (\d+) registers", log, re.S)
    assert len(found) == 1, log
    stores, loads, regs = map(int, found[0])
    print(f"kda_kernel: {regs} registers, spill stores {stores}, loads {loads}")
    assert stores == 0 and loads == 0, log


_IMPORT_BUILDS_NOTHING = """
import torch
import tensorframes_tpu_torch
from tensorframes_tpu_torch.models import KimiLinearLM
from tensorframes_tpu_torch.ops import _cuda_build, kda
assert "kda" not in _cuda_build._libs and "kda" not in _cuda_build.build_logs
x = torch.zeros(1, 1, 1, 128, device="cuda")
kda.kda(x, x, x, torch.zeros(1, 1, 1, device="cuda"), x)
torch.cuda.synchronize()
assert "kda" in _cuda_build._libs and kda.kda.launches == 1
print("ok")
"""


@pytest.mark.card
def test_importing_the_port_builds_no_library(card):
    """A fresh process imports the port and the model: no library is loaded
    or built until the first launch, which builds and loads ``kda``."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_BUILDS_NOTHING], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr
