"""On the card: one cell runs briefly through the entry point and comes
out correct; skips without a card."""
import json
import subprocess
import sys

import pytest

from bench.tests.common import ROOT


@pytest.mark.cuda
def test_one_cell_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "q6.sf100.scan",
         "--seed", str(2 ** 31 + 99), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert out["metrics"]["rows_per_s"]["value"] > 0
