"""Geometric debug drawing, the vdb-stream equivalent (port of
gfxexp_tpu/utils/debug_draw.py).

The reference pipes points/lines/triangles/AABBs to an external TCP viewer
for eyeball-debugging CPU geometry code (reference: ENABLE_VDB helpers
drawPoint/drawLine/drawCross/drawAabb/drawTriangle/setColor,
common_host.h:26-122, ext/vdb). A headless server has no viewer socket,
so this collector writes standard PLY files (points + colored line/triangle
elements) that any mesh tool (MeshLab, Blender, polyscope) opens.

Usage (host-side debugging, numpy in/out):

    dd = DebugDraw()
    dd.set_color(1, 0, 0)
    dd.point(p)
    dd.line(a, b)
    dd.aabb(lo, hi)
    dd.triangle(a, b, c)
    dd.save("out/debug.ply")
"""

from __future__ import annotations

import numpy as np


class DebugDraw:
    def __init__(self):
        self._color = (1.0, 1.0, 1.0)
        self._verts = []  # (xyz, rgb)
        self._edges = []  # (i, j)
        self._faces = []  # (i, j, k)

    # -- state -------------------------------------------------------------
    def set_color(self, r, g, b):
        """reference: vdb_color / setColor (common_host.h:30)."""
        self._color = (float(r), float(g), float(b))
        return self

    def _push(self, p):
        self._verts.append((np.asarray(p, np.float64).reshape(3),
                            self._color))
        return len(self._verts) - 1

    # -- primitives (reference: common_host.h:34-122) ----------------------
    def point(self, p):
        self._push(p)
        return self

    def points(self, ps):
        for p in np.asarray(ps, np.float64).reshape(-1, 3):
            self._push(p)
        return self

    def line(self, a, b):
        ia = self._push(a)
        ib = self._push(b)
        self._edges.append((ia, ib))
        return self

    def vector(self, origin, direction, length=1.0):
        o = np.asarray(origin, np.float64)
        d = np.asarray(direction, np.float64)
        n = np.linalg.norm(d)
        if n > 0:
            d = d / n
        return self.line(o, o + d * length)

    def cross(self, p, size=0.1):
        """reference: drawCross (common_host.h:59)."""
        p = np.asarray(p, np.float64)
        h = size * 0.5
        for ax in range(3):
            e = np.zeros(3)
            e[ax] = h
            self.line(p - e, p + e)
        return self

    def aabb(self, lo, hi):
        """reference: drawAabb (common_host.h:77)."""
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        c = [np.where(np.asarray(m, bool), hi, lo)
             for m in ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                       (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))]
        for a, b in ((0, 1), (1, 2), (2, 3), (3, 0),
                     (4, 5), (5, 6), (6, 7), (7, 4),
                     (0, 4), (1, 5), (2, 6), (3, 7)):
            self.line(c[a], c[b])
        return self

    def triangle(self, a, b, c):
        ia = self._push(a)
        ib = self._push(b)
        ic = self._push(c)
        self._faces.append((ia, ib, ic))
        return self

    def frame(self, origin, t, b, n, size=0.2):
        """Draw a tangent frame as RGB axes."""
        saved = self._color
        for v, col in ((t, (1, 0, 0)), (b, (0, 1, 0)), (n, (0, 0, 1))):
            self.set_color(*col)
            self.vector(origin, v, size)
        self._color = saved
        return self

    # -- output ------------------------------------------------------------
    def save(self, path: str):
        """ASCII PLY with per-vertex colors + edge and face elements."""
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(self._verts)}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
            f.write(f"element edge {len(self._edges)}\n")
            f.write("property int vertex1\nproperty int vertex2\n")
            f.write(f"element face {len(self._faces)}\n")
            f.write("property list uchar int vertex_indices\n")
            f.write("end_header\n")
            for p, (r, g, b) in self._verts:
                f.write(f"{p[0]:.7g} {p[1]:.7g} {p[2]:.7g} "
                        f"{int(255*r)} {int(255*g)} {int(255*b)}\n")
            for i, j in self._edges:
                f.write(f"{i} {j}\n")
            for i, j, k in self._faces:
                f.write(f"3 {i} {j} {k}\n")
        return path

    @property
    def counts(self):
        return (len(self._verts), len(self._edges), len(self._faces))
