"""Multi-device sharding of the port (gfxexp_torch/parallel/sharding.py) on
torch.distributed: four gloo ranks on the CPU, spawned once for the module
(torch.multiprocessing.spawn, a file:// rendezvous), against the unsharded
calls and gfxexp_tpu's sharding on the 8-device CPU mesh.

Bars:
- render_sample_sharded at 16x16 equals render_sample in lane order bit for
  bit, and JAX's render_sample_sharded within 1e-5 absolute (the bar of
  tests/test_parallel.py:20);
- svgf_frame_sharded over two frames at 32x32, 2 filter stages (a halo of
  3 rows against 8-row shards), equals svgf_frame bit for bit: the output
  and the temporal state;
- nrc_train_step_dp on a batch of 512 with JAX's state matches JAX's
  nrc_train_step_dp at tests/test_torch_nrc.py's bars: the loss within
  rtol 1e-5; the all-reduced, count-normalised gradient that Adam takes
  within 1e-2 of each leaf's largest entry (the gradient bar), against
  JAX's psum'd gradient, recovered from its first moment (mu / (1 - b1),
  less the weight decay); the moments within the same bar; the params
  and EMA within 1e-5 (the train_step bar) wherever JAX's gradient is at
  least 1e-2 of its leaf's largest (the firm weights, over a tenth of
  each leaf). Elsewhere the params are not checked: Adam's first step
  moves a weight by lr * g / (|g| + 1e-8), so a gradient inside the
  gradient bar, summed over other slices (4 ranks here, 8 devices in JAX)
  through bf16-rounded activations, can move it anywhere in [-lr, lr]
  (seen: a gradient of 5.2e-7 in JAX and 2.0e-6 here, against a largest
  of 0.22, parts a weight by 1.4e-5; the port's own unsharded train_step
  parts from the sharded step by up to 0.02 on such weights). The last
  clause, every weight within twice the learning rate, holds for any
  first step and checks nothing more.
The spawned ranks re-import this module: JAX is imported inside the tests
only.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")
import torch_scenes as S  # noqa: E402

WORLD = 4
RES = 16
SVGF_RES = 32
NRC_BATCH = 512


def _worker(rank, tmp):
    """One rank: the sharded render, SVGF and NRC step; rank 0 also the
    unsharded calls, all saved to tmp/out.pt."""
    import torch.distributed as dist

    import gfxexp_torch.scene.builder as TB
    from gfxexp_torch.parallel import sharding
    from gfxexp_torch.render import pathtrace as tpt
    from gfxexp_torch.render.camera import make_camera
    from gfxexp_torch.render.gbuffer import render_gbuffer
    from gfxexp_torch.scene.compile import compile_scene
    from gfxexp_torch.techniques import svgf
    from gfxexp_torch.techniques.nrc import network as tn

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=WORLD, rank=rank)
    try:
        mesh = sharding.make_mesh()
        scene, bvh = compile_scene(S.box_scene(TB))
        cam = make_camera(**S.BOX_CAMERA)
        cfg = tpt.PTConfig(max_path_length=3)
        out = {"render": sharding.render_sample_sharded(
            mesh, scene, bvh, cam, RES, RES, 0, cfg)}
        if rank == 0:
            out["render_single"] = tpt.render_sample(scene, bvh, cam, RES,
                                                     RES, 0, cfg)

        w = h = SVGF_RES
        scfg = svgf.SVGFConfig(num_filter_stages=2)
        gb = render_gbuffer(scene, bvh, cam, cam, w, h, 0, False)
        st_a = svgf.make_svgf_state(w, h, "cpu")
        st_b = svgf.make_svgf_state(w, h, "cpu")
        frames = []
        for f in range(2):
            lighting = tpt.render_sample(scene, bvh, cam, w, h, f,
                                         cfg).reshape(h, w, 3)
            out_b, st_b = sharding.svgf_frame_sharded(mesh, st_b, gb,
                                                      lighting, scfg)
            if rank == 0:
                out_a, st_a = svgf.svgf_frame(st_a, gb, lighting, scfg)
                frames.append((out_a, out_b))
        out["svgf"] = frames
        out["svgf_state"] = {
            name: (getattr(st_a, name), getattr(st_b, name))
            for name in ("prev_noisy", "moments", "sample_count",
                         "taa_history")}

        nrc = torch.load(os.path.join(tmp, "nrc_in.pt"))
        tcfg = tn.NRCConfig()
        seen, real = {}, tn.apply_step

        def recording(state, grads, cfg):
            seen["grads"] = grads
            return real(state, grads, cfg)

        tn.apply_step = recording
        try:
            st, loss = sharding.nrc_train_step_dp(
                mesh, nrc["state"], nrc["q"], nrc["t"], nrc["m"], tcfg)
        finally:
            tn.apply_step = real
        out["nrc"] = (st, loss)
        out["nrc_grads"] = seen["grads"]
        if rank == 0:
            torch.save(out, os.path.join(tmp, "out.pt"))
    finally:
        dist.destroy_process_group()


def _jax_nrc_state():
    """JAX's fresh NRC state with a non-zero output layer (as
    tests/test_torch_nrc.py makes it) and a seeded batch."""
    import jax
    import jax.numpy as jnp

    from gfxexp_tpu.techniques.nrc import network as jn

    cfg = jn.NRCConfig()
    st = jn.init_nrc(jax.random.PRNGKey(1), cfg)
    w = jax.random.normal(jax.random.PRNGKey(5),
                          st["params"]["weights"][-1].shape) * 0.1
    for part in ("params", "ema"):
        st[part]["weights"] = list(st[part]["weights"])
        st[part]["weights"][-1] = jnp.array(w)
    rng = np.random.default_rng(3)
    q = rng.random((NRC_BATCH, 14)).astype(np.float32)
    t = (rng.random((NRC_BATCH, 3)) * 2.0).astype(np.float32)
    m = rng.random(NRC_BATCH) < 0.8
    return cfg, st, (q, t, m)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results (rank 0's file) and JAX's NRC inputs."""
    import jax

    from gfxexp_torch.techniques.nrc import network as tn

    tmp = str(tmp_path_factory.mktemp("sharding"))
    jcfg, jst, (q, t, m) = _jax_nrc_state()
    tst = tn.nrc_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                                device="cpu")
    torch.save({"state": tst, "q": torch.from_numpy(q),
                "t": torch.from_numpy(t), "m": torch.from_numpy(m)},
               os.path.join(tmp, "nrc_in.pt"))
    torch.multiprocessing.spawn(_worker, args=(tmp,), nprocs=WORLD,
                                join=True)
    out = torch.load(os.path.join(tmp, "out.pt"))
    out["jax_nrc"] = (jcfg, jst, (q, t, m))
    return out


def test_sharded_render_matches_single_and_jax(ranks):
    import jax
    import jax.numpy as jnp

    import gfxexp_tpu.scene.builder as JB
    from gfxexp_torch.render.camera import lane_from_pixel
    from gfxexp_tpu.parallel.sharding import make_mesh
    from gfxexp_tpu.parallel.sharding import render_sample_sharded as jrss
    from gfxexp_tpu.render.camera import make_camera as j_camera
    from gfxexp_tpu.render.pathtrace import PTConfig
    from gfxexp_tpu.scene.compile import compile_scene as jcompile

    lanes = ranks["render"]
    order = lane_from_pixel(torch.arange(RES * RES), RES, RES)
    assert torch.equal(lanes[order], ranks["render_single"])
    js, jb = jcompile(S.box_scene(JB))
    jl = jrss(make_mesh(jax.devices()[:8]), js, jb, j_camera(**S.BOX_CAMERA),
              RES, RES, jnp.uint32(0), PTConfig(max_path_length=3))
    np.testing.assert_allclose(lanes.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5)


def test_sharded_svgf_matches_single(ranks):
    for f, (a, b) in enumerate(ranks["svgf"]):
        assert torch.equal(a, b), (f, float((a - b).abs().max()))
    for name, (a, b) in ranks["svgf_state"].items():
        assert torch.equal(a, b), name


def test_nrc_dp_step_matches_jax(ranks):
    import jax
    import jax.numpy as jnp

    from gfxexp_torch.core.tree import tree_leaves
    from gfxexp_torch.techniques.nrc import network as tn
    from gfxexp_tpu.parallel.sharding import make_mesh, nrc_train_step_dp

    jcfg, jst, (q, t, m) = ranks["jax_nrc"]
    jst2, jl = nrc_train_step_dp(make_mesh(jax.devices()[:8]), jst,
                                 jnp.asarray(q), jnp.asarray(t),
                                 jnp.asarray(m), jcfg)
    st, loss = ranks["nrc"]
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    ref = tn.nrc_state_from_jax(jax.tree_util.tree_map(np.asarray, jst2),
                                device="cpu")
    before = tn.nrc_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                                   device="cpu")
    for g, mu, p in zip(tree_leaves(ranks["nrc_grads"]),
                        tree_leaves(ref["opt"]["mu"]),
                        tree_leaves(before["params"])):
        jg = (mu / (1 - tn.ADAM_B1) - tn.WEIGHT_DECAY * p).numpy()
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-2 * np.abs(jg).max())
    for moment in ("mu", "nu"):
        for a, b in zip(tree_leaves(st["opt"][moment]),
                        tree_leaves(ref["opt"][moment])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-2 * float(b.abs().max()))
    lr = jcfg.learning_rate
    for part in ("params", "ema"):
        for a, b, mu in zip(tree_leaves(st[part]), tree_leaves(ref[part]),
                            tree_leaves(ref["opt"]["mu"])):
            firm = (mu.abs() >= 1e-2 * mu.abs().max()).numpy()
            diff = (a - b).abs().numpy()
            assert firm.mean() > 0.1
            assert diff[firm].max() <= 1e-5, part
            assert diff.max() <= 2 * lr, part
    assert int(st["step"]) == int(ref["step"]) == 1


def test_make_mesh_raises_without_a_process_group():
    from gfxexp_torch.parallel import sharding

    with pytest.raises(RuntimeError, match="init_process_group"):
        sharding.make_mesh()

