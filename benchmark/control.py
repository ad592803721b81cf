"""The readings the limits of `correct` are set from, on the card at the
cell's own size:

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 ... \\
        --control-seeds 1 2 3 [--frames 8]

For each seed it builds the cell's scene, runs the app's frame loop for
`--frames` frames as a run's window does (harness.window), and prints the numbers the
run's check compares (the program against the float64 reference, at the
frames and pixels the seed draws, as a run draws them); for each control
seed also the same numbers with the reference computed in bfloat16 put in
the program's place. One JSON line a seed. The benchmark's own runs do
not run this."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", type=int, nargs=2, default=None)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import harness

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    _, cfg, traffic = harness.cell(bench, args.workload)
    loop = harness.load_module("loops", traffic["app"])
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        sess = harness.Session(cfg, traffic, seed, args.device, args.size)
        rng = np.random.default_rng(seed)
        _, store, frames, state = harness.window(sess, loop, rng,
                                                 args.frames)
        del sess.scene, sess.bvh
        row = {"workload": args.workload, "seed": seed, "frames": frames}
        kinds = ([False] if seed in args.seeds else []) + (
            [True] if seed in args.control_seeds else [])
        for control in kinds:
            row["control" if control else "program"] = {
                name: v for name, v, _ in harness.judge(
                    sess, loop, store, frames, rng, state, control)[0]}
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del sess, store
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
