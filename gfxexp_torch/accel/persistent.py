"""Wide-row BVH walk: the wrappers of the CUDA kernel and its plain version.

Replaces the TPU kernel `_make_persistent_kernel`
(gfxexp_tpu/accel/pallas_persistent.py:102, launched by `_run_persistent`
:352) in both its instantiations, closest hit and any hit.

The kernel (csrc/widerow_traverse.cu) runs one thread per ray with a
per-thread stack over the [R, 64] row table in HBM. A walk step is one
dependent load of a 256-byte row followed by a few dozen FLOPs, so the kernel
is bound by the latency of those dependent loads, not by arithmetic; the
design keeps every thread's loads independent of the others (no packets)
and leans on the 50 MB L2, which holds the bench scene's table whole. The
TPU kernel's pools, row slots, `sched_k` batching and 128-lane packets
existed to keep VMEM busy and carry no meaning here.

Semantics shared by kernel and plain version (and the TPU kernel): slab
tests against [t_min, best_t] with `_safe_inv` reciprocals, hit children
descended nearest first (a 4- or 8-wide sorting network on the entry
distance, the rest pushed far to near), Baldwin-Weber leaf tests
`den_ok & u>=0 & v>=0 & u+v<=1 & t>t_min & t<best_t`. Any hit stops at the
first accepted triangle. A ray with t_max < 0 does no work. Misses return
t = t_max, tri = -1, u = v = 0.

On a CUDA tensor the wrappers launch the kernel or raise; the plain version
runs only for tensors on the CPU (and in tests and chip_smoke.py, which
compare the two).
"""

from __future__ import annotations

import ctypes

import torch

from gfxexp_torch.accel.traverse import HitInfo
from gfxexp_torch.accel.widerow import COUNT_SHIFT, WIDTH, WideRowBVH

# kernel launches per instantiation, counted where the kernel is launched
launch_counts = {"closest": 0, "any": 0}

# sorting networks (ascending), pairs applied in sequence; the kernel
# applies the same ones so ties order identically
_NET4 = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))
_NET8 = (
    (0, 1), (2, 3), (4, 5), (6, 7),
    (0, 2), (1, 3), (4, 6), (5, 7),
    (1, 2), (5, 6), (0, 4), (3, 7),
    (1, 5), (2, 6), (3, 6), (2, 4), (1, 2), (3, 5), (4, 5), (3, 4),
)


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def stack_depth(bvh: WideRowBVH) -> int:
    """Ordered-descent stack bound: at most arity-1 pushes per level."""
    return int(bvh.max_depth + 2) * max(bvh.arity - 1, 1)


def _safe_inv(v):
    tiny = torch.where(v < 0, -1e-12, 1e-12)
    return 1.0 / torch.where(torch.abs(v) < 1e-12, tiny, v)


def _prepare(bvh: WideRowBVH, o, d, t_min, t_max):
    if not isinstance(bvh, WideRowBVH):
        raise TypeError(f"expected WideRowBVH, got {type(bvh).__name__}")
    if bvh.arity not in (4, 8):
        raise ValueError(f"wide-row walk supports arity 4 or 8, got "
                         f"{bvh.arity}")
    if bvh.width != WIDTH or bvh.max_leaf * 12 + 4 > WIDTH:
        raise ValueError(f"bad row format width={bvh.width} "
                         f"max_leaf={bvh.max_leaf}")
    nodes = bvh.nodes
    if (nodes.dim() != 2 or nodes.shape[1] != WIDTH
            or nodes.dtype != torch.float32 or not nodes.is_contiguous()):
        raise ValueError(f"nodes must be a contiguous float32 [R, {WIDTH}] "
                         f"tensor, got {tuple(nodes.shape)} {nodes.dtype}")
    if nodes.device != o.device:
        raise ValueError(f"rays on {o.device}, table on {nodes.device}")
    return (nodes, *prepare_rays(o, d, t_min, t_max))


def prepare_rays(o, d, t_min, t_max):
    """Checks shared by the walks' kernels and plain versions: o, d [N, 3]
    float32 on one device, made contiguous, and t_min, t_max as contiguous
    [N] float32 (a scalar is filled on the rays' device)."""
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"o, d must be [N, 3], got {tuple(o.shape)} "
                         f"{tuple(d.shape)}")
    if o.dtype != torch.float32 or d.dtype != torch.float32:
        raise ValueError("o, d must be float32")
    dev = o.device
    if d.device != dev:
        raise ValueError(f"rays on {dev}, directions on {d.device}")
    n = o.shape[0]

    def per_ray(x):
        if not isinstance(x, torch.Tensor):  # a fill: no host-device copy
            return torch.full((n,), float(x), device=dev)
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"t_min/t_max must be float32 on {dev}")
        return torch.broadcast_to(x, (n,)).contiguous()

    return o.contiguous(), d.contiguous(), per_ray(t_min), per_ray(t_max)


# ---------------------------------------------------------------------------
# plain PyTorch version: every active ray takes one step per iteration
# ---------------------------------------------------------------------------


def walk_plain(bvh: WideRowBVH, o, d, t_min, t_max, any_hit: bool,
               base=None, start=None, with_stats: bool = False):
    """The kernel's walk written as tensor code: each iteration loads the
    current row of every active ray, tests its children or triangles, and
    descends, pops or retires the ray. Same arithmetic, same order.

    `start` [N] is the row each ray starts at and `base` [N] the row its
    child indices count from (a BLAS's first row in a flat table of several
    BLAS, as the two-level walk uses it); both default to 0. with_stats=True
    also returns the number of rows each ray visited [N] int64."""
    nodes, o, d, t_min, t_max = _prepare(bvh, o, d, t_min, t_max)
    nodes_i = nodes.view(torch.int32)
    K, L = bvh.arity, bvh.max_leaf
    net = _NET4 if K == 4 else _NET8
    n, dev = o.shape[0], o.device
    n_rows = nodes.shape[0]
    inv = _safe_inv(d)
    best_t = t_max.clone()
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stack = torch.full((n, stack_depth(bvh)), -1, dtype=torch.int64,
                       device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)

    rows_visited = torch.zeros(n, dtype=torch.int64, device=dev)

    act = torch.nonzero(t_max >= 0.0).squeeze(1)  # ray ids still walking
    # their current rows, and the rows those count from
    cur = (torch.zeros_like(act) if start is None
           else start.to(device=dev, dtype=torch.int64)[act])
    a_base = (torch.zeros_like(act) if base is None
              else base.to(device=dev, dtype=torch.int64)[act])
    while act.numel():
        if with_stats:
            rows_visited[act] += 1
        ridx = torch.clamp(a_base + cur, 0, n_rows - 1)
        row = nodes[ridx]
        row_i = nodes_i[ridx]
        ox, oy, oz = o[act].unbind(1)
        dx, dy, dz = d[act].unbind(1)
        ix, iy, iz = inv[act].unbind(1)
        tmin = t_min[act]
        bt = best_t[act]
        a_sp = sp[act]
        nxt = torch.full_like(cur, -1)
        done = torch.zeros(act.shape, dtype=torch.bool, device=dev)
        leaf = row[:, WIDTH - 1] > 0.5

        # internal rows: slab-test the K children, push all but the nearest
        nears, metas, valids = [], [], []
        for k in range(K):
            c = row[:, 7 * k:7 * k + 6]
            tx0 = (c[:, 0] - ox) * ix
            tx1 = (c[:, 3] - ox) * ix
            ty0 = (c[:, 1] - oy) * iy
            ty1 = (c[:, 4] - oy) * iy
            tz0 = (c[:, 2] - oz) * iz
            tz1 = (c[:, 5] - oz) * iz
            near = torch.maximum(
                torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                torch.maximum(torch.minimum(tz0, tz1), tmin))
            far = torch.minimum(
                torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                torch.minimum(torch.maximum(tz0, tz1), bt))
            meta = row_i[:, 7 * k + 6].to(torch.int64)
            ok = ~leaf & (near <= far) & (meta >= 0)
            nears.append(torch.where(ok, near, torch.inf))
            metas.append(meta)
            valids.append(ok)
        for a, b in net:
            swap = nears[a] > nears[b]
            nears[a], nears[b] = (torch.where(swap, nears[b], nears[a]),
                                  torch.where(swap, nears[a], nears[b]))
            metas[a], metas[b] = (torch.where(swap, metas[b], metas[a]),
                                  torch.where(swap, metas[a], metas[b]))
            valids[a], valids[b] = (torch.where(swap, valids[b], valids[a]),
                                    torch.where(swap, valids[a], valids[b]))
        for s in range(K - 1, 0, -1):
            push = torch.nonzero(valids[s]).squeeze(1)
            stack[act[push], a_sp[push]] = metas[s][push]
            a_sp = a_sp + valids[s].to(torch.int64)
        nxt = torch.where(valids[0], metas[0], nxt)

        # leaf rows: Baldwin-Weber tests of the row's triangles
        packed = row_i[:, WIDTH - 4]
        fst = packed & ((1 << COUNT_SHIFT) - 1)
        cnt = torch.where(leaf, packed >> COUNT_SHIFT, 0)
        bu, bv, btri = best_u[act], best_v[act], best_tri[act]
        for j in range(L):
            r = row[:, 12 * j:12 * j + 12]
            den = r[:, 0] * dx + r[:, 1] * dy + r[:, 2] * dz
            num = r[:, 0] * ox + r[:, 1] * oy + r[:, 2] * oz + r[:, 3]
            den_ok = torch.abs(den) > 1e-12
            t = -num / torch.where(den_ok, den, 1.0)
            px = ox + t * dx
            py = oy + t * dy
            pz = oz + t * dz
            u = r[:, 4] * px + r[:, 5] * py + r[:, 6] * pz + r[:, 7]
            v = r[:, 8] * px + r[:, 9] * py + r[:, 10] * pz + r[:, 11]
            ok = ((j < cnt) & den_ok & (u >= 0.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t > tmin) & (t < bt))
            if any_hit:
                ok = ok & ~done  # the kernel returns on the first accept
                done = done | ok
            bt = torch.where(ok, t, bt)
            bu = torch.where(ok, u, bu)
            bv = torch.where(ok, v, bv)
            btri = torch.where(ok, (fst + j).to(torch.int32), btri)
        best_t[act], best_u[act], best_v[act], best_tri[act] = bt, bu, bv, btri

        # descend, else pop, else retire
        pop = (nxt < 0) & (a_sp > 0) & ~done
        a_sp = a_sp - pop.to(torch.int64)
        popped = stack[act, torch.clamp(a_sp, 0, stack.shape[1] - 1)]
        nxt = torch.where(pop, popped, nxt)
        sp[act] = a_sp
        keep = nxt >= 0
        act, cur, a_base = act[keep], nxt[keep], a_base[keep]
    hit = HitInfo(t=best_t, tri=best_tri, u=best_u, v=best_v,
                  hit=best_tri >= 0)
    return (hit, rows_visited) if with_stats else hit


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def walk_cuda(bvh: WideRowBVH, o, d, t_min, t_max, any_hit: bool) -> HitInfo:
    """Launch csrc/widerow_traverse.cu on PyTorch's current stream. Raises
    if the kernel cannot be built or the launch is refused."""
    from gfxexp_torch.csrc.build import load_library

    nodes, o, d, t_min, t_max = _prepare(bvh, o, d, t_min, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"walk_cuda needs CUDA tensors, got {o.device}")
    lib = load_library("widerow_traverse")
    depth = stack_depth(bvh)
    if depth > lib.widerow_max_stack():
        raise ValueError(f"stack depth {depth} exceeds the kernel's bound "
                         f"{lib.widerow_max_stack()}")
    n = o.shape[0]
    dev = o.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.widerow_walk_launch(
                int(any_hit), bvh.arity, _ptr(nodes), nodes.shape[0],
                bvh.max_leaf, depth, n, _ptr(o), _ptr(d), _ptr(t_min),
                _ptr(t_max), _ptr(t), _ptr(u), _ptr(v), _ptr(tri), _ptr(hit),
                ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"widerow_walk launch failed: CUDA error {rc}")
        launch_counts["any" if any_hit else "closest"] += 1
    return HitInfo(t=t, tri=tri, u=u, v=v, hit=hit)


def _walk(bvh, o, d, t_min, t_max, any_hit):
    if o.device.type == "cuda":
        return walk_cuda(bvh, o, d, t_min, t_max, any_hit)
    if o.device.type == "cpu":
        return walk_plain(bvh, o, d, t_min, t_max, any_hit)
    raise ValueError(f"no wide-row walk for device {o.device}")


def intersect_closest_widerow(bvh: WideRowBVH, o, d, t_min=1e-4,
                              t_max=1e30) -> HitInfo:
    """Closest hit of rays o, d [N, 3] against the wide-row table."""
    return _walk(bvh, o, d, t_min, t_max, any_hit=False)


def intersect_any_widerow(bvh: WideRowBVH, o, d, t_min=1e-4,
                          t_max=1e30) -> torch.Tensor:
    """Occlusion [N] bool: any triangle with t_min < t < t_max."""
    return _walk(bvh, o, d, t_min, t_max, any_hit=True).hit
