"""The training cells end to end on the CPU at the tiny size: the port's
CPU path (the kernels' plain versions) against the plain reference for the
DPO loss and the SFT loss, and the check catching each fault planted under
the timed path."""

import pytest

from bench_h100.run import run_cell
from bench_h100.tests.common import tiny_spec

SEED = 2 ** 31 + 77


def test_sound_run_is_correct_and_reports_its_numbers():
    rec = run_cell(tiny_spec(), SEED, 0.0, False, device="cpu")
    assert rec["correct"], rec["check_rows"]
    assert rec["steps"] >= 1 and rec["failed"] == 0
    assert rec["metrics"]["dpo_step_s"] > 0
    assert [r[0] for r in rec["check_rows"]] == ["loss_gap", "grad_gap",
                                                 "change_gap", "score_gap"]


def test_w8a8_program_against_the_w8a8_reference():
    spec = tiny_spec(bits=8, act_bits=8, act_bwd_int8=True)
    rec = run_cell(spec, SEED, 0.0, False, device="cpu")
    assert rec["correct"], rec["check_rows"]


@pytest.mark.parametrize("traffic", ["dpo-copo-b2", "sft-opa-b4"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_fault_under_the_timed_path_is_not_correct(traffic, fault):
    rec = run_cell(tiny_spec(traffic), SEED, 0.0, False, device="cpu",
                   faults=(fault,))
    assert not rec["correct"], rec["check_rows"]


def test_sft_run_is_correct_and_reports_its_rate():
    rec = run_cell(tiny_spec("sft-opa-b4"), SEED, 0.0, False, device="cpu")
    assert rec["correct"], rec["check_rows"]
    assert rec["metrics"]["sft_tokens_per_s"] > 0


def test_same_seed_same_numbers():
    a = run_cell(tiny_spec(), SEED, 0.0, False, device="cpu")
    b = run_cell(tiny_spec(), SEED, 0.0, False, device="cpu")
    assert a["check_rows"] == b["check_rows"]
