"""A short run of a cell on the card, as the check runs it (`cuda`-marked:
it skips where there is no CUDA device; run it on the card with
`python -m pytest benchmark/tests/test_bench_card.py -q`)."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_short_cell_on_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cornellbox.restir_rearch",
         "--seed", "2147483777", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    want = ({"launches_per_frame", "gbuffer_ms", "restir_ms", "walk_ms",
             "walk_roofline", "idle_share"} if trace
            else {"frame_ms", "frame_ms_p95", "setup_s"})
    assert set(res["metrics"]) == want
