"""On the card, at the cells' own sizes: each precision control (the
reference in the precision below the configuration's), put through the
cell's own comparison, comes out not correct on three seeds. Run there with
``python3 -m pytest portbench/tests -m card``."""

import pytest

from portbench import control
from portbench.tests import tiny

pytestmark = pytest.mark.card

SEEDS = [2**31 + 101, 2**31 + 103, 2**31 + 107]


@pytest.mark.parametrize("workload", ["gpt2m.score.s1024", "gpt2m.score.s128", "meanvar.k16"])
def test_precision_control_fails(card, workload):
    for rec in control.readings(tiny.REPO, workload, SEEDS, card):
        print(rec)
        assert rec["correct"] is False, rec
