"""PyTorch port: the key factorization of the aggregate's key stage
(`ops.factorize_keys`, routed by `frame.factorize_keys`).

On the CPU: the kernel's route as a pure function of device and dtype, the
plain version (``torch.unique``) against NumPy on negative keys, the int64
extremes, the kernel's empty-slot marker as a key, int32 keys, one key, no
rows and several keys through the combined codes; `frame.factorize_keys`
giving what NumPy gives for every key array of `tests/test_torch_aggregate.py`;
the route taking ``torch.unique`` where the kernel finds too many keys.

On a card (marked ``card``, skipped without one): the kernel equal to
``torch.unique(sorted=True, return_inverse=True)`` bit for bit at the
benchmark cell's shape (100M int64 keys, 16 uniform), on sparse ids over the
whole int64 range, negative keys with the marker, int32 keys, exactly its
capacity of keys, one key, no rows, ragged lengths and misaligned views; one
key past its capacity taking ``torch.unique``; `frame.factorize_keys` on the
card equal to its CPU result; a segment-plan call launching each pass once.
The file imports no JAX, so the card's machine runs it without the
repository's conftest:

    python3 -m pytest tests/test_torch_factorize_keys.py --noconftest -p no:cacheprovider -q
"""

import re

import numpy as np
import pytest
import torch

import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch import dsl
from tensorframes_tpu_torch.frame import factorize_keys
from tensorframes_tpu_torch.ops import factorize_keys as fk
from tensorframes_tpu_torch.utils import telemetry
from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

from _torch_card import build_logs_afresh
from _torch_card import card  # noqa: F401 - the fixture

I32, I64 = torch.int32, torch.int64
MIN64, MAX64 = np.iinfo(np.int64).min, np.iinfo(np.int64).max


@pytest.fixture(autouse=True)
def _isolated():
    reset_stats()
    telemetry.reset()
    yield
    reset_stats()
    telemetry.reset()


_ROUTES = [
    ("cuda", I64, True),
    ("cuda", I32, True),
    ("cpu", I64, False),
    ("cpu", I32, False),
    ("meta", I64, False),
    ("cuda", torch.float32, False),  # NaN and signed zeros: torch.unique's rules
    ("cuda", torch.float64, False),
    ("cuda", torch.int16, False),
    ("cuda", torch.uint8, False),
    ("cuda", torch.bool, False),
    ("cuda", np.dtype(object), False),  # string keys factorize on the host
]


@pytest.mark.parametrize("device,dtype,kernel", _ROUTES, ids=[f"{d}-{t}" for d, t, _ in _ROUTES])
def test_route_is_a_function_of_device_and_dtype(device, dtype, kernel):
    assert fk.takes_kernel(torch.device(device), dtype) is kernel


@pytest.mark.parametrize("keys", [torch.arange(5), torch.arange(5.0, device="meta")],
                         ids=["cpu-int64", "meta-float"])
def test_kernel_refuses_what_it_does_not_take(keys):
    before = dict(fk.factorize.launches)
    with pytest.raises(ValueError, match="no kernel"):
        fk.factorize(keys)
    assert fk.factorize.launches == before


# key arrays of one column: name -> int64 or int32 values
_ONE_KEY = {
    "negative": np.array([-3, 7, -3, -9, 0, 7, -1], np.int64),
    "extremes": np.array([MAX64, MIN64, 0, MIN64, -1, MAX64, 1], np.int64),
    "marker": np.array([5, fk.EMPTY_KEY, -2, fk.EMPTY_KEY, 5], np.int64),
    "int32": np.array([2**31 - 1, -(2**31), 4, -4, 4, 0], np.int32),
    "one_key": np.full(9, 12, np.int64),
    "one_row": np.array([-5], np.int64),
    "no_rows": np.zeros(0, np.int64),
    "no_rows_int32": np.zeros(0, np.int32),
}


@pytest.mark.parametrize("name", list(_ONE_KEY))
def test_plain_version_matches_numpy(name):
    keys = _ONE_KEY[name]
    uniq, inverse = fk.factorize_reference(torch.from_numpy(keys))
    want_uniq, want_inverse = np.unique(keys, return_inverse=True)
    assert uniq.dtype == torch.from_numpy(keys).dtype and inverse.dtype == I64
    np.testing.assert_array_equal(uniq.numpy(), want_uniq)
    np.testing.assert_array_equal(inverse.numpy(), want_inverse.reshape(-1))


def _numpy_factorization(arrays):
    """(distinct keys of each column, group of each row) in sorted group
    order: each column's codes by `np.unique`, rows by their code tuples."""
    uniqs, codes = zip(*(np.unique(a, return_inverse=True) for a in arrays))
    if len(arrays) == 1:
        return list(uniqs), codes[0].reshape(-1)
    rows, inverse = np.unique(np.stack([c.reshape(-1) for c in codes], 1), axis=0,
                              return_inverse=True)
    return [u[rows[:, j]] for j, u in enumerate(uniqs)], inverse.reshape(-1)


# key columns of tests/test_torch_aggregate.py (numeric ones), and the
# one-column cases above
_rng = np.random.default_rng(0)
_KEY_SETS = {
    "keyed_int64": [_rng.integers(0, 7, 200)],
    "keyed_int32": [_rng.integers(0, 7, 200).astype(np.int32)],
    "two_int_keys": [np.array([0, 0, 1, 1, 0]), np.array([0, 1, 0, 1, 0])],
    "float_and_int_keys": [np.array([1.5, 1.5, 2.5, -1.0, 2.5]), np.array([7, 8, 7, 7, 7])],
    "three_keys": [np.array([0, 0, 0, 1, 1]), np.array([0, 0, 1, 0, 0]),
                   np.array([5, 5, 5, 5, 5], np.int32)],
    "nan_keys": [np.array([2.0, np.nan, 1.0, np.nan, 2.0, -0.5, np.nan])],
    "nan_and_second_key": [np.array([np.nan, 1.0, np.nan, 1.0]), np.array([1, 1, 1, 2])],
    "empty": [np.zeros(0, np.int64)],
    "two_extreme_keys": [_ONE_KEY["extremes"], _ONE_KEY["negative"]],
    **{name: [keys] for name, keys in _ONE_KEY.items()},
}


def _assert_factorization(key_out, inverse, arrays):
    want_keys, want_inverse = _numpy_factorization(arrays)
    assert inverse.dtype == I64
    np.testing.assert_array_equal(inverse.cpu().numpy(), want_inverse)
    for j, want in enumerate(want_keys):
        got = key_out[f"c{j}"].cpu().numpy()
        assert got.dtype == arrays[j].dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(_KEY_SETS))
def test_factorize_keys_on_the_cpu_matches_numpy(name):
    arrays = _KEY_SETS[name]
    names = [f"c{j}" for j in range(len(arrays))]
    key_out, inverse = factorize_keys(names, [torch.from_numpy(a) for a in arrays])
    _assert_factorization(key_out, inverse, arrays)
    # the route is counted on a card only
    assert not any(k.startswith("factorize.") for k in stats())


def test_route_takes_torch_unique_past_the_kernels_capacity(monkeypatch):
    """Where the kernel reports more keys than it holds (None), the route
    gives ``torch.unique``'s result; where it answers, its answer is taken
    and counted."""
    keys = torch.from_numpy(_ONE_KEY["negative"])
    want = fk.factorize_reference(keys)
    monkeypatch.setattr(fk, "takes_kernel", lambda device, dtype: True)
    monkeypatch.setattr(fk, "factorize", lambda k: None)
    key_out, inverse = factorize_keys(["k"], [keys])
    assert torch.equal(key_out["k"], want[0]) and torch.equal(inverse, want[1])
    assert "factorize.kernel" not in stats()
    answer = (torch.tensor([-1]), torch.zeros(len(keys), dtype=I64))
    monkeypatch.setattr(fk, "factorize", lambda k: answer)
    key_out, inverse = factorize_keys(["k"], [keys])
    assert key_out["k"] is answer[0] and inverse is answer[1]
    assert stats() == {"factorize.kernel": 1.0}


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _capacity_keys(n, distinct, seed):
    """``n`` int64 keys taking ``distinct`` values spread over the int64
    range, each at least once, in random order."""
    gen = torch.Generator().manual_seed(seed)
    values = torch.randint(-(2**62), 2**62, (distinct,), generator=gen) * 2 + 1
    values = torch.unique(values)
    assert len(values) == distinct
    idx = torch.cat([torch.arange(distinct), torch.randint(0, distinct, (n - distinct,),
                                                          generator=gen)])
    return values[idx[torch.randperm(n, generator=gen)]]


def _negative_and_marker(gen, device):
    keys = torch.randint(-50, 0, (100_003,), generator=gen, device=device)
    keys[::97] = fk.EMPTY_KEY
    keys[5] = MAX64
    return keys


def _card_cases(device):
    """name -> a function drawing the case's keys on ``device``."""
    gen = torch.Generator(device=device).manual_seed(2**31 + 25)
    return {
        "cell_shape": lambda: torch.randint(0, 16, (100_000_000,), generator=gen, device=device),
        "sparse_1000": lambda: torch.randint(MIN64, MAX64, (1000,), generator=gen, device=device)[
            torch.randint(0, 1000, (1_000_003,), generator=gen, device=device)],
        "negative_and_marker": lambda: _negative_and_marker(gen, device),
        "int32": lambda: torch.randint(-(2**31), 2**31 - 1, (300,), generator=gen, device=device,
                                       dtype=I32)[torch.randint(0, 300, (1_000_001,), generator=gen,
                                                                device=device)],
        "int32_extremes": lambda: torch.tensor([2**31 - 1, -(2**31), 0, 7] * 1001, dtype=I32,
                                               device=device),
        "capacity": lambda: _capacity_keys(200_000, fk.CAPACITY, 1).to(device),
        "capacity_with_marker": lambda: torch.cat([
            _capacity_keys(200_000, fk.CAPACITY - 1, 2),
            torch.tensor([fk.EMPTY_KEY])]).to(device),
        "one_key": lambda: torch.full((1_000_000,), -3, dtype=I64, device=device),
        "one_row": lambda: torch.tensor([7], device=device),
        "no_rows": lambda: torch.zeros(0, dtype=I64, device=device),
        "ragged_length": lambda: torch.randint(0, 40, (10_007,), generator=gen, device=device),
        "ragged_int32": lambda: torch.randint(-9, 9, (10_007,), generator=gen, device=device,
                                              dtype=I32),
        "offset_by_one": lambda: torch.randint(0, 16, (1_000_001,), generator=gen,
                                               device=device)[1:],
        "int32_offset_by_three": lambda: torch.randint(-5, 5, (1_000_003,), generator=gen,
                                                       device=device, dtype=I32)[3:],
        "strided": lambda: torch.randint(0, 16, (200_002,), generator=gen, device=device)[::2],
        "column_of_a_matrix": lambda: torch.randint(0, 9, (3, 100_001), generator=gen,
                                                    device=device).t(),
    }


_CARD_CASES = list(_card_cases("cpu"))


@pytest.mark.card
@pytest.mark.parametrize("name", _CARD_CASES)
def test_kernel_equals_torch_unique(card, name):
    keys = _card_cases(card)[name]()
    before = dict(fk.factorize.launches)
    uniq, inverse = fk.factorize(keys)
    want_uniq, want_inverse = torch.unique(keys, sorted=True, return_inverse=True)
    torch.cuda.synchronize()
    assert uniq.dtype == want_uniq.dtype and inverse.dtype == want_inverse.dtype == I64
    assert uniq.shape == want_uniq.shape and inverse.shape == want_inverse.shape
    assert torch.equal(uniq, want_uniq) and torch.equal(inverse, want_inverse)
    # the distinct keys in a tensor of their own length
    assert uniq.untyped_storage().nbytes() == uniq.numel() * uniq.element_size()
    launched = 0 if keys.numel() == 0 else 1
    assert fk.factorize.launches == {k: v + launched for k, v in before.items()}


@pytest.mark.card
@pytest.mark.parametrize("marker", [False, True], ids=["capacity_plus_one", "capacity_and_marker"])
def test_one_key_past_the_capacity_takes_torch_unique(card, marker):
    keys = _capacity_keys(300_000, fk.CAPACITY + (not marker), 3)
    if marker:  # the kernel's capacity counts the marker key too
        keys = torch.cat([keys, torch.tensor([fk.EMPTY_KEY])])
    keys = keys.to(card)
    before = dict(fk.factorize.launches)
    assert fk.factorize(keys) is None
    assert fk.factorize.launches == {"distinct": before["distinct"] + 1,
                                     "lookup": before["lookup"]}
    key_out, inverse = factorize_keys(["k"], [keys])
    want_uniq, want_inverse = torch.unique(keys, sorted=True, return_inverse=True)
    assert torch.equal(key_out["k"], want_uniq) and torch.equal(inverse, want_inverse)
    assert stats() == {"factorize.torch": 1.0}


@pytest.mark.card
def test_a_million_keys_stop_the_distinct_pass_early(card):
    keys = torch.randperm(100_000_000, device=card)
    fk.factorize(keys)  # builds and warms
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    assert fk.factorize(keys) is None
    end.record()
    end.synchronize()
    # the blocks stop within a few chunks of rows: the clearing, a fraction
    # of the 0.24 ms a whole pass takes at 3.35 TB/s, and the host read
    assert start.elapsed_time(end) < 1.0


@pytest.mark.card
@pytest.mark.parametrize("name", list(_KEY_SETS))
def test_factorize_keys_on_the_card_matches_the_cpu(card, name):
    arrays = _KEY_SETS[name]
    names = [f"c{j}" for j in range(len(arrays))]
    key_out, inverse = factorize_keys(names, [torch.from_numpy(a).to(card) for a in arrays])
    assert inverse.device == card
    _assert_factorization(key_out, inverse, arrays)
    integer = [a.dtype.kind == "i" for a in arrays]
    tensors = len(arrays) + (len(arrays) > 1)  # each column, and the combined codes
    want = {"factorize.kernel": float(sum(integer) + (len(arrays) > 1))}
    want["factorize.torch"] = tensors - want["factorize.kernel"]
    assert stats() == {k: v for k, v in want.items() if v}


@pytest.mark.card
def test_segment_plan_launches_each_pass_once_a_call(card):
    gen = torch.Generator(device=card).manual_seed(16)
    keys = torch.randint(0, 16, (1_000_000,), generator=gen, device=card)
    v = torch.rand(1_000_000, 8, generator=gen, device=card)
    df = tft.TensorFrame([tft.Column("k", keys), tft.Column("v", v)]).repartition(8)
    m = dsl.reduce_mean(dsl.block(df, "v", tf_name="m_input"), axes=[0]).named("m")
    q = dsl.reduce_mean(dsl.square(dsl.block(df, "v", tf_name="q_input")), axes=[0]).named("q")
    grouped = tft.group_by(df, "k")
    feed = {"m_input": "v", "q_input": "v"}
    tft.aggregate([m, q], grouped, feed_dict=feed, device=card)  # lowers once
    reset_stats()
    before = dict(fk.factorize.launches)
    out = tft.aggregate([m, q], grouped, feed_dict=feed, device=card)
    assert stats() == {"aggregate.plan.segment": 1.0, "aggregate.segment.fused": 1.0,
                       "factorize.kernel": 1.0}
    assert fk.factorize.launches == {k: v + 1 for k, v in before.items()}
    np.testing.assert_array_equal(out.host_values("k"), np.arange(16))
    counts = torch.bincount(keys, minlength=16).double()[:, None]
    want = torch.zeros(16, 8, dtype=torch.float64, device=card).index_add_(0, keys, v.double())
    np.testing.assert_allclose(out.host_values("m"), (want / counts).cpu().numpy(), rtol=1e-6)


@pytest.mark.card
def test_ptxas_spills_nothing(card, tmp_path):
    """What ptxas said of the library built afresh: every kernel (each key
    type's instantiation) compiled without a register spill."""
    log = build_logs_afresh(["factorize_keys"], tmp_path)["factorize_keys"]
    ptxas = {}  # kernel<key type> -> [registers, spill store bytes, spill load bytes]
    for m in re.finditer(
        r"Compiling entry function '\w*?\d([a-z_]+_kernel)(I[ix]E)?\w*'.*?(\d+) bytes spill stores, "
        r"(\d+) bytes spill loads.*?Used (\d+) registers", log, re.S,
    ):
        key = m.group(1) + {"IiE": "<int32>", "IxE": "<int64>"}.get(m.group(2), "")
        ptxas[key] = [int(m.group(5)), int(m.group(3)), int(m.group(4))]
    assert ptxas, "no kernel in the build log"
    spilled = {k: r for k, r in ptxas.items() if r[1] or r[2]}
    assert not spilled, f"ptxas spilled in {spilled} ([registers, stores, loads])"
