"""Each cell run once through the command on the card, briefly, and found
correct (skips without a card)."""
import json
import subprocess
import sys

import pytest

from perfbench.harness.manifest import ROOT, load

WORKLOADS = [w["name"] for w in load()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload, "--seed", str(2**33 + 5), "--seconds", "5",
         "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200, check=True,
    )
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, out.stderr[-2000:]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
