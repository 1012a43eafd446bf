"""A whole run of each estimate cell, cut to a CPU size, judged correct;
and judged not correct with each fault the cell can have planted in the
program underneath (perfbench/harness/faults.py)."""
import pytest
import torch

torch.set_num_threads(1)

from perfbench.tests._tiny import drive  # noqa: E402

CELLS = ("mf_n131072.ot", "mf_n131072.log")


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    correct, checks = drive(workload)
    assert correct, checks


@pytest.mark.parametrize("fault", ["unchanged_step", "half_draw", "altered_value"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault):
    correct, checks = drive(workload, fault)
    assert not correct, checks
