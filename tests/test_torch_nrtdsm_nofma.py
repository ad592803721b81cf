"""The port's NRTDSM and shells (techniques/nrtdsm.py, shell.py) against
gfxexp_tpu's compiled without FMA contraction (a subprocess with
XLA_FLAGS=--xla_cpu_max_isa=SSE4_2), on the inputs of
tests/test_torch_nrtdsm.py: the cubic solver and the shell height solve,
intersect_nrtdsm (the per-triangle oracle), intersect_nrtdsm_v2 over the
slab sweep and over the prism BVH (2,048 base triangles), the exact
two-triangle intersector ordered and flat, and intersect_shell on a
straight and on a tilted shell (multi-material).

Bars: roots, found flags and the height solve's (h, b1, b2, found) equal;
every intersector's t, uv, prim, hit and steps equal bit for bit, a
shell's materials too; normals within 2e-6.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch
from test_torch_nrtdsm import (_cubics, find_height_inputs, nrtdsm_geoms,
                               rays, shell_geoms)

from gfxexp_torch.techniques import nrtdsm as TN
from gfxexp_torch.techniques import shell as TS

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX = textwrap.dedent("""
    import json, sys
    import numpy as np, jax.numpy as jnp
    sys.path.insert(0, "tests")
    from test_torch_nrtdsm import (_cubics, find_height_inputs,
                                   nrtdsm_geoms, shell_geoms)
    from gfxexp_tpu.techniques import nrtdsm as JN, shell as JS
    out = sys.argv[2]
    for name, kind, geo, kw, seed in json.loads(sys.argv[1]):
        if kind == "shell":
            g = shell_geoms(**geo, packages="j")[0]
            fn = JS.intersect_shell
        else:
            g = nrtdsm_geoms(**geo, packages="j")[0]
            fn = getattr(JN, kind)
        rays = np.load(out + f"/{name}.npz")
        h = fn(g, jnp.asarray(rays["o"]), jnp.asarray(rays["d"]), **kw)
        keys = ["t", "hit", "uv", "normal", "prim", "steps"]
        keys += ["mat"] if kind == "shell" else []
        np.savez(out + f"/{name}_jax.npz",
                 **{k: np.asarray(getattr(h, k)) for k in keys})
    k, lo, hi = _cubics(2000, 1)
    r, f = JN.solve_cubic_in_interval(jnp.asarray(k), jnp.asarray(lo),
                                      jnp.asarray(hi))
    fh = JN.find_height(*find_height_inputs(jnp.asarray))
    np.savez(out + "/solve_jax.npz", r=np.asarray(r), f=np.asarray(f),
             **{f"fh{i}": np.asarray(x) for i, x in enumerate(fh)})
""")

# (name, intersector, geometry arguments, keyword arguments, ray seed)
CASES = [("v1", "intersect_nrtdsm", dict(base=1), {}, 21),
         ("v2", "intersect_nrtdsm_v2", dict(base=3), {}, 22),
         ("v2_bvh", "intersect_nrtdsm_v2", dict(base=32, size=64), {}, 23),
         ("exact", "intersect_nrtdsm_exact", dict(base=3, lit=1), {}, 24),
         ("exact_flat", "intersect_nrtdsm_exact", dict(base=2, lit=1),
          {"ordered": False}, 25),
         ("shell_straight", "shell", dict(base=2, tilt=0.0, h_scale=0.5),
          {"n_segments": 3}, 26),
         ("shell_tilted", "shell", dict(base=2, materials=True), {}, 27)]


def test_intersectors_equal_jax_without_fma(tmp_path):
    for name, kind, geo, kw, seed in CASES:
        o, d = rays(150 if name == "v2_bvh" else 300, seed)
        np.savez(tmp_path / f"{name}.npz", o=o, d=d)
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _JAX, json.dumps(CASES),
                          str(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    for name, kind, geo, kw, seed in CASES:
        jh = np.load(tmp_path / f"{name}_jax.npz")
        r = np.load(tmp_path / f"{name}.npz")
        o, d = torch.from_numpy(r["o"]), torch.from_numpy(r["d"])
        if kind == "shell":
            th = TS.intersect_shell(shell_geoms(**geo, packages="t")[0], o, d,
                                    **kw)
        else:
            th = getattr(TN, kind)(nrtdsm_geoms(**geo, packages="t")[0], o,
                                   d, **kw)
        for k in ("t", "hit", "uv", "prim", "steps"):
            np.testing.assert_array_equal(getattr(th, k).numpy(), jh[k],
                                          err_msg=f"{name}.{k}")
        np.testing.assert_allclose(th.normal.numpy(), jh["normal"], rtol=0,
                                   atol=2e-6, err_msg=f"{name}.normal")
        assert jh["hit"].sum() > 30, name
        if kind == "shell":
            np.testing.assert_array_equal(th.mat.numpy(), jh["mat"])
    k, lo, hi = _cubics(2000, 1)
    root, found = TN.solve_cubic_in_interval(
        torch.from_numpy(k), torch.from_numpy(lo), torch.from_numpy(hi))
    js = np.load(tmp_path / "solve_jax.npz")
    np.testing.assert_array_equal(root.numpy(), js["r"])
    np.testing.assert_array_equal(found.numpy(), js["f"])
    for i, x in enumerate(TN.find_height(*find_height_inputs(
            torch.from_numpy))):
        np.testing.assert_array_equal(x.numpy(), js[f"fh{i}"])
