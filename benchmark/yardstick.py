"""The benchmark's fixed arithmetic: the card's peak memory bandwidth, the
least time a walk launch needs, which device kernels are walks, the busy
time of a device trace and its breakdown.

A walk launch must at least read its rays (origin, direction, t_min,
t_max: 32 B each) and the walk's tables once, and write its hits (t, u,
v, triangle, hit flag: 17 B a ray); at the published HBM3 bandwidth of an
H100 SXM (3.35 TB/s) that takes (32 + 17) B x rays + table bytes over the
bandwidth. Walks are bound by bytes at that count (the port's kernels 1
and 6, which these cells take). The count comes from the launch's inputs,
so a later walk is read against the same work."""

from __future__ import annotations

import bisect
import re

HBM_BYTES_PER_S = 3.35e12
RAY_IN_BYTES = 32
RAY_OUT_BYTES = 17
_WALK = re.compile(r"\w*_walk\w*")


def table_bytes(bvh) -> int:
    """Bytes of the tables a walk of `bvh` reads: a wide-row table's rows,
    a skip-link structure's node and triangle tables; for any other
    structure, every tensor it holds."""
    import torch

    kind = type(bvh).__name__
    if kind == "WideRowBVH":
        parts = [bvh.nodes]
    elif kind == "SkipBVH":
        parts = [bvh.node_pack, bvh.tri_pack]
    else:
        parts = [v for v in vars(bvh).values() if isinstance(v, torch.Tensor)]
    return int(sum(p.numel() * p.element_size() for p in parts
                   if p is not None))


def walk_bound_s(rays: int, tables: int) -> float:
    return ((RAY_IN_BYTES + RAY_OUT_BYTES) * rays + tables) / HBM_BYTES_PER_S


def op_name(name: str) -> str:
    """A device operation's name without its parameter list and without
    `void`, template arguments kept (they name the op of PyTorch's
    elementwise kernels), cut to 160 characters."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    name = name.replace("(anonymous namespace)", "anon")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name.strip()[:160]


def kernel_name(name: str) -> str:
    """A device kernel's function name alone: no namespace, template
    arguments or parameters."""
    return op_name(name).split("<")[0].split("::")[-1]


def is_walk(name: str) -> bool:
    return bool(_WALK.fullmatch(kernel_name(name)))


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def busy_union(spans):
    """Merged [start, end] intervals of (start, end) spans."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def breakdown(kernels, cpu, passes, top=10):
    """{"device_ops": the `top` device operations by summed time,
    "idle_gaps": the `top` host activities by the summed device-idle time
    that began while they ran}, seconds. kernels: (name, start us, end
    us); cpu: (start, end, name) host events; passes: (start, end, pass
    name) ranges of the frame loop's passes."""
    by_op = {}
    for name, s, e in kernels:
        key = op_name(name)
        by_op[key] = by_op.get(key, 0.0) + (e - s) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    merged = busy_union([(s, e) for _, s, e in kernels])
    cpu = sorted(cpu)
    starts = [c[0] for c in cpu]
    passes = sorted(passes)
    pstarts = [p[0] for p in passes]
    gaps = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(pstarts, mid) - 1
        where = (passes[i][2] if i >= 0 and passes[i][1] >= mid
                 else "between passes")
        j = bisect.bisect_right(starts, mid) - 1
        what = "host"
        for k in range(j, max(j - 400, -1), -1):
            if cpu[k][1] >= mid:
                what = cpu[k][2]
                break
        key = f"{where}: {what}"
        gaps[key] = gaps.get(key, 0.0) + (s1 - e0) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
