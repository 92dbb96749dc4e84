"""The numbers of the check, on readings made by hand."""

import math

import pytest
import torch

from bench_h100 import check

REF = {"a": 1.0, "b": 2.0, "c": 4.0, "tiny": 1e-6}


def test_loss_gap_is_the_worst_step():
    assert check.loss_gap([1.0, 2.2, 3.0], [1.0, 2.0, 3.3]) == \
        pytest.approx(0.1)


def test_leaf_gap_scales_small_leaves_by_the_median():
    prog = dict(REF, tiny=0.0, c=4.4)
    # median 1.5: the tiny leaf's gap 1e-6 / 1.5, c's 0.4 / 4
    assert check.leaf_gap(prog, REF) == pytest.approx(0.1)
    assert check.leaf_gap({"a": 1.0}, REF) == math.inf


def test_moving_leaves_out_gradients_under_a_thousandth_of_the_median():
    assert check.moving(REF) == {"a", "b", "c"}


def test_leaf_mean_gap_averages_every_leaf():
    prog = dict(REF, a=1.3)
    assert check.leaf_mean_gap(prog, REF) == pytest.approx(0.2 / 4)


def test_widest_gap_on_the_rows_both_hold():
    ref = {"x": torch.zeros(2, 3)}
    prog = {"x": torch.tensor([[0.0, -0.5, 0.1]])}
    assert check.widest_gap(prog, ref) == pytest.approx(0.5)


def test_judge_holds_each_number_to_its_limit():
    ok, rows = check.judge([("a", 0.1), ("b", 2.0)], {"a": 0.2, "b": 1.0})
    assert not ok and rows == [("a", 0.1, 0.2), ("b", 2.0, 1.0)]
    assert not check.judge([("a", float("nan"))], {"a": 1.0})[0]
    assert check.judge([("a", 0.2)], {"a": 0.2})[0]
