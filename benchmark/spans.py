"""The port's spans (gfxexp_torch/utils/trace.py) in a profiled stretch of
a cell: which span launched each device operation, and for each span name
its calls, host time, self host time, launches, device time, and the time
the device waited for it, a frame.

    python3 benchmark/spans.py --workload <cell> --seed <n> [--out FILE]

builds the cell's scene as a run does, warms the app's frame loop up, then
profiles a stretch of it as a traced run does (`trace_skip` frames
unprofiled, then `trace_frames` under torch.profiler, each pass a profiler
range). It prints one line per span name on stderr and the whole table as
JSON (to FILE with --out). It needs a CUDA device.

A device operation belongs to the innermost span whose host interval
holds the runtime call that launched it; the profiler records one
correlation id for both. A walk kernel that no runtime call claims (a
launch the profiler did not see) is paired with the walk spans in time
order: the i-th walk kernel with the i-th `gfx.walk.*` span, which is
exact on one in-order stream. A span's launches and device time count the
operations of its children too, each once under every span name that
holds it; its self host time leaves out the parts its child spans cover.
The device's idle gaps are put down to the span that launched the
operation ending each gap: the device waited for that launch.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import sys

import yardstick

# the CUDA API's launch and copy calls (cudaLaunchKernel, cuLaunchKernel)
_RUNTIME = re.compile(r"cu(da)?[A-Z]\w*")


class Span:
    """One span of the stretch: name, host start and end (us), and the
    index of its nearest enclosing span (None at the top)."""

    __slots__ = ("name", "start", "end", "parent")

    def __init__(self, name, start, end, parent=None):
        self.name, self.start, self.end = name, start, end
        self.parent = parent


def nest(spans):
    """The spans sorted by start, each given its nearest enclosing span
    (spans of one thread nest or follow one another)."""
    spans = sorted(spans, key=lambda s: (s.start, -s.end))
    open_ = []
    for i, s in enumerate(spans):
        while open_ and spans[open_[-1]].end <= s.start:
            open_.pop()
        s.parent = open_[-1] if open_ else None
        open_.append(i)
    return spans


def device_ops(events, marks):
    """The device operations of a trace's device events (name, start, end,
    correlation id): the frame loop's pass ranges (`marks`) and the
    program's spans, which the profiler may draw on the device's timeline
    as annotations, are not operations."""
    return [e for e in events
            if e[0] not in marks and not e[0].startswith("gfx.")]


def innermost(spans, starts, t):
    """The index of the innermost span of `spans` (nested, `starts` their
    starts) whose interval holds time t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    while i is not None and i >= 0:
        if spans[i].end >= t:
            return i
        i = spans[i].parent
    return None


def attribute(spans, ops, launches):
    """The span that launched each device operation: a list, one index of
    `spans` (nested) or None per operation of `ops` ((name, start, end,
    correlation id)). `launches` maps a correlation id to the host time of
    the runtime call that launched it; walk kernels it lacks are paired
    with the `gfx.walk.*` spans in time order."""
    starts = [s.start for s in spans]
    owner = [innermost(spans, starts, launches[op[3]])
             if op[3] in launches else None for op in ops]
    walks = [i for i, op in enumerate(ops) if yardstick.is_walk(op[0])]
    if any(ops[i][3] not in launches for i in walks):
        walk_spans = [j for j, s in enumerate(spans)
                      if s.name.startswith("gfx.walk.")]
        if len(walk_spans) == len(walks):
            by_start = sorted(walks, key=lambda i: ops[i][1])
            for i, j in zip(by_start, walk_spans):
                owner[i] = j
    return owner


def per_span(spans, ops, owner, frames):
    """{span name: calls, host ms, self host ms, launches, device ms, wait
    ms} a frame, and under None the operations no span launched. Launches
    count kernels (yardstick.is_kernel); device time every operation; wait
    the device's idle time before the operations, from the end of all the
    work before each to its start."""
    rows = {}

    def row(name):
        return rows.setdefault(name, {"calls": 0, "host_ms": 0.0,
                                      "self_host_ms": 0.0, "launches": 0,
                                      "device_ms": 0.0, "wait_ms": 0.0})

    children = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append(s)
    for j, s in enumerate(spans):
        r = row(s.name)
        r["calls"] += 1
        r["host_ms"] += (s.end - s.start) * 1e-3
        covered = sum(e - b for b, e in yardstick.busy_union(
            [(c.start, c.end) for c in children.get(j, [])]))
        r["self_host_ms"] += (s.end - s.start - covered) * 1e-3
    busy_until = min((op[1] for op in ops), default=0.0)
    for op, j in sorted(zip(ops, owner), key=lambda oj: oj[0][1]):
        wait = max(op[1] - busy_until, 0.0)
        busy_until = max(busy_until, op[2])
        names = set()
        while j is not None:
            names.add(spans[j].name)
            j = spans[j].parent
        for name in names or {None}:
            r = row(name)
            r["launches"] += yardstick.is_kernel(op[0])
            r["device_ms"] += (op[2] - op[1]) * 1e-3
            r["wait_ms"] += wait * 1e-3
    return {name: {k: v / frames for k, v in r.items()}
            for name, r in rows.items()}


# ---------------------------------------------------------------------------
# a profiled stretch on the card
# ---------------------------------------------------------------------------


def _from_trace(events, marks):
    """(spans, device operations, launches) of a profiler's raw events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, dev, launches = [], [], {}
    for e in events:
        name = e.name()
        s = e.start_ns() * 1e-3
        t = s + e.duration_ns() * 1e-3
        if e.device_type() == cuda:
            dev.append((name, s, t, e.correlation_id()))
        elif name.startswith("gfx."):
            spans.append(Span(name, s, t))
        elif _RUNTIME.fullmatch(name):
            launches[e.correlation_id()] = s
    return nest(spans), device_ops(dev, marks), launches


def stretch(workload: str, seed: int, device: str = "cuda", size=None):
    """Profile a stretch of the cell's frame loop on the card. Returns
    (the per-span table, a summary: frames, operations and kernels a
    frame, how many no span launched, walk kernels paired in order, the
    stretch's wall and idle share). `size` and a CPU `device` are for the
    benchmark's own tests."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import harness

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    _, cfg, traffic = harness.cell(bench, workload)
    loop = harness.load_module("loops", traffic["app"])
    sess = harness.Session(cfg, traffic, seed, device, size)
    warm = harness.FrameTimer(loop.first_pass(sess), sess.sync)
    loop.run(sess, traffic["warmup_frames"], warm)
    sess.sync()

    skip, k = traffic["trace_skip"], traffic["trace_frames"]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    timer = harness.FrameTimer(loop.first_pass(sess), sess.sync)
    t0 = {}

    def on_frame(f):
        if f == skip:
            sess.sync()
            prof.start()
            t0["wall"] = time.perf_counter()
            timer.annotate = record_function

    timer.on_frame = on_frame
    loop.run(sess, skip + k, timer)
    sess.sync()
    wall = time.perf_counter() - t0["wall"]
    prof.stop()
    spans, ops, launches = _from_trace(
        prof.profiler.kineto_results.events(), set(timer.samples))
    owner = attribute(spans, ops, launches)
    table = per_span(spans, ops, owner, k)
    busy = sum(e - s for s, e in yardstick.busy_union(
        [(op[1], op[2]) for op in ops])) * 1e-6
    walks = [op for op in ops if yardstick.is_walk(op[0])]
    summary = {
        "workload": workload, "seed": seed, "frames": k,
        "device": (torch.cuda.get_device_name(sess.device)
                   if sess.device.type == "cuda" else "cpu"),
        "ops_per_frame": len(ops) / k,
        "kernels_per_frame": sum(yardstick.is_kernel(op[0])
                                 for op in ops) / k,
        "kernels_in_no_span_per_frame": sum(
            yardstick.is_kernel(op[0]) for op, j in zip(ops, owner)
            if j is None) / k,
        "walk_kernels_unlinked": sum(op[3] not in launches for op in walks),
        "walk_kernels": len(walks),
        "stretch_ms_per_frame": wall * 1e3 / k,
        "idle_share": 1.0 - busy / wall if ops else None}
    return table, summary


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    table, summary = stretch(args.workload, args.seed)
    for name in sorted(table, key=lambda n: (n is None, n or "")):
        r = table[name]
        print(f"span {name or '(none)'}: calls {r['calls']:.2f}, host "
              f"{r['host_ms']:.3f} ms, self {r['self_host_ms']:.3f} ms, "
              f"launches {r['launches']:.1f}, device {r['device_ms']:.3f} "
              f"ms, wait {r['wait_ms']:.3f} ms a frame", file=sys.stderr)
    line = json.dumps({"summary": summary, "spans": {
        name or "(none)": r for name, r in table.items()}})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(json.dumps(summary))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    main()
