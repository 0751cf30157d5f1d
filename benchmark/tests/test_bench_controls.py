"""On the card: every cell's control, at the cell's own size and on three
seeds, comes out not correct (the reference in the nearest lower precision
in the program's place). Skips without a GPU."""

import pytest

from benchmark import control as CTL
from benchmark import harness as H

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      H.load_benchmark()["workloads"]])
def test_control_is_not_correct(workload, card):
    for seed in SEEDS:
        assert not CTL.control(workload, seed, 4, card)["correct"]
