"""Each loop's comparison agrees with the port at a tiny size on the CPU:
the program's numbers sit at or under their limits, and the control (the
reference in bfloat16 put in the program's place) over them, on every
number a cell compares. The same readings at the cells' own size on the
card are control.py's."""

import json
import os

import numpy as np
import pytest

from conftest import ROOT

BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def readings(workload, seed, size=(48, 27), frames=4):
    import harness

    _, cfg, traffic = harness.cell(BENCHMARK, workload)
    loop = harness.load_module("loops", traffic["app"])
    sess = harness.Session(cfg, traffic, seed, "cpu", size)
    rng = np.random.default_rng(seed)
    _, store, checked, state = harness.window(sess, loop, rng, frames)
    out = {}
    for control in (False, True):
        out[control] = harness.judge(sess, loop, store, checked, rng, state,
                                     control)[0]
    return out


@pytest.mark.parametrize("workload", CELLS)
def test_program_within_and_control_beyond(workload):
    r = readings(workload, seed=2147483651)
    for name, value, limit in r[False]:
        assert value <= limit, (name, value, limit)
    for name, value, limit in r[True]:
        assert value > limit, (name, value, limit)
