"""On a card: one short run of each cell through the command, correct, its
result line as the contract has it. Skipped without a card."""

import json
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.conftest import BENCHMARKED


@pytest.mark.cuda
@pytest.mark.parametrize("workload", BENCHMARKED)
def test_a_short_run_on_the_card(cuda_card, workload):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload, "--seed",
                          str(2**31 + 3), "--seconds", "2", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
