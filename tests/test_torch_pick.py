"""The nearest-first pick of csrc/widerow_walk.cuh, as a numpy model, against
the visit order of the plain version's rescanning pick
(gfxexp_torch.accel.persistent.walk_entries_plain).

The kernel scans the boxes once, keeps the K smallest keys (entry distance,
index) of the boxes a ray enters within [t_min, t_max) in a sorted buffer
and the keys of the first M such boxes in a spill list, takes the buffered
keys in order while their distance is below the ray's best t, and looks
again, for the keys after the last one taken, only when the buffer runs
dry while more boxes passed the first scan: in the spill list when it
holds them all, else in every box. The plain version rescans every box at
every pick. The model below follows the kernel step by step (buffer,
spill, refill, stop); each case checks that it visits the same boxes in
the same order as the plain version, with buffer sizes K = 1, 2, 4 and the
kernel's kPick (spill 2K each, and kSpill with kPick), on random boxes, on
boxes with equal entry distances, with dead rays and a best t that drops
as the visits hit, closest and any hit. Needs no card.
"""

import numpy as np
import pytest
import torch

from gfxexp_torch.accel.persistent import (
    _safe_inv,
    entry_slabs,
    walk_entries_plain,
)
from gfxexp_torch.accel.traverse import HitInfo
from gfxexp_torch.csrc.build import header_constant

KPICK = header_constant("kPick")
KSPILL = header_constant("kSpill")
N_RAYS, N_BOXES = 160, 96


def _boxes(rng, kind):
    """[C, 3] lo, hi: random boxes in a 10-unit cube; with "ties", every
    box is repeated and a row of boxes shares its entry faces, so many
    entry distances are equal and the index decides."""
    c = rng.uniform(-5, 5, (N_BOXES, 3))
    ext = rng.uniform(0.2, 2.5, (N_BOXES, 3))
    lo, hi = c - ext, c + ext
    if kind == "ties":
        lo[1::2], hi[1::2] = lo[0::2], hi[0::2]  # duplicated boxes
        lo[:12, 0] = -3.0  # one entry plane for rays along +x
        hi[:12, 0] = rng.uniform(-2.0, 4.0, 12)
    return (torch.from_numpy(lo.astype(np.float32)),
            torch.from_numpy(hi.astype(np.float32)))


def _rays(rng, kind):
    o = rng.uniform(-5, 5, (N_RAYS, 3)).astype(np.float32)
    o[:, 0] = rng.uniform(-12, -8, N_RAYS)  # in front of the boxes
    d = rng.uniform(-5, 5, (N_RAYS, 3)) - o  # through the boxes
    if kind == "ties":
        d[::3] = [1.0, 0.0, 0.0]  # along +x: equal entry distances
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_min = np.where(np.arange(N_RAYS) % 4 == 0, 0.0, 1e-4).astype(np.float32)
    t_max = np.where(np.arange(N_RAYS) % 9 == 4, -1.0,  # dead
                     np.where(np.arange(N_RAYS) % 2, 1e30, 25.0)).astype(
                         np.float32)
    return (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_min),
            torch.from_numpy(t_max))


def _hit_t(rng, near):
    """The t a visit of box c finds for ray r: beyond its entry distance,
    or none (inf) for three pairs in four."""
    h = near.numpy() + rng.uniform(0.0, 6.0, near.shape).astype(np.float32)
    return np.where(rng.random(near.shape) < 0.75, np.inf, h).astype(
        np.float32)


def _plain_order(lo, hi, rays, hit_t, any_hit):
    """Each ray's boxes in the order walk_entries_plain visits them."""
    o, d, t_min, t_max = rays
    order = [[] for _ in range(N_RAYS)]

    def visit(r, c, best_t):
        for ri, ci in zip(r.tolist(), c.tolist()):
            order[ri].append(ci)
        t = torch.from_numpy(hit_t[r.numpy(), c.numpy()])
        hit = t < best_t
        return HitInfo(t=torch.where(hit, t, best_t), tri=hit.to(torch.int32),
                       u=torch.zeros_like(t), v=torch.zeros_like(t), hit=hit)

    walk_entries_plain(lo, hi, o, d, t_min, t_max, any_hit, True, visit)
    return order


def _model_order(near, ok_geom, t_max, hit_t, any_hit, k, m):
    """The kernel's pick, step by step: (each ray's visits, the refills
    from the spill list, the refills by a scan of every box). near [N, C]
    and ok_geom [N, C] (the ray enters the box at all, near <= its own far)
    are the first scan's slab results; a box passes at best t exactly when
    ok_geom and near <= best t."""
    near = near.numpy()
    ok_geom = ok_geom.numpy()
    order, from_spill, from_scan = [], 0, 0
    for r in range(N_RAYS):
        seen = []
        order.append(seen)
        best = float(t_max[r])
        if best < 0:
            continue

        def smallest(cands, after):
            keys = sorted((near[r, c], c) for c in cands
                          if ok_geom[r, c] and near[r, c] < best
                          and (after is None or (near[r, c], c) > after))
            return keys[:k], len(keys) > k

        passed = [c for c in range(N_BOXES)
                  if ok_geom[r, c] and near[r, c] < best]
        spill = passed[:m]
        buf, more = smallest(range(N_BOXES), None)
        last = None
        while True:
            if not buf:
                if not more:
                    break
                if len(passed) <= m:
                    from_spill += 1
                    buf, more = smallest(spill, last)
                else:
                    from_scan += 1
                    buf, more = smallest(range(N_BOXES), last)
                if not buf:
                    break
            nr, c = buf.pop(0)
            if nr >= best:
                break
            seen.append(c)
            if hit_t[r, c] < best:
                best = float(hit_t[r, c])
                if any_hit:
                    break
            last = (nr, c)
    return order, from_spill, from_scan


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("k, m", [(1, 2), (2, 4), (4, 8), (KPICK, 2 * KPICK),
                                  (KPICK, KSPILL)])
def test_buffered_pick_visits_what_the_rescan_visits(k, m, any_hit, kind):
    rng = np.random.default_rng(31 + 7 * k + m + (kind == "ties"))
    lo, hi = _boxes(rng, kind)
    rays = _rays(rng, kind)
    o, d, t_min, t_max = rays
    # the first scan's slab results, against t_max, and the box's own far
    near, _ = entry_slabs(lo, hi, o, _safe_inv(d), t_min, t_max)
    _, ok_geom = entry_slabs(lo, hi, o, _safe_inv(d), t_min,
                             torch.full_like(t_max, torch.inf))
    hit_t = _hit_t(rng, near)
    want = _plain_order(lo, hi, rays, hit_t, any_hit)
    got, from_spill, from_scan = _model_order(near, ok_geom, t_max.numpy(),
                                              hit_t, any_hit, k, m)
    assert got == want
    live = t_max.numpy() >= 0
    assert not any(want[r] for r in np.flatnonzero(~live))  # dead rays
    assert sum(map(len, want)) > N_RAYS // 2  # the rays visit boxes
    if kind == "ties":
        ties = sum(len(set(near[r, want[r]].tolist())) < len(want[r])
                   for r in range(N_RAYS))
        assert ties > 0  # equal distances were visited, by index
    if not any_hit:
        assert max(map(len, want)) > 4  # best t drops over several visits
        # both refill paths ran (few rays pass more than kSpill boxes)
        assert from_spill and (from_scan or m == KSPILL)
