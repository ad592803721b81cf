"""Run one cell of the port's benchmark once and print its result line:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It needs as many CUDA devices as the cell asks
for and fails without them. Its caches (the port's built kernels, Triton's
and the CUDA driver's) live under .cache/ in the checkout."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    cache = os.path.join(ROOT, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    sys.path.insert(0, ROOT)
    import harness

    rc, _ = harness.run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_process=T_PROCESS)
    sys.exit(rc)


if __name__ == "__main__":
    main()
