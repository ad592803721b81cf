"""What the loops compare, shared: the reference's scene and camera at a
frame, the pixels drawn from the seed, the program's G-buffer read at
them, and the animated scene after the program's update against the
reference's. Each check returns the number compared; with `control` the
candidate is the reference itself computed in bfloat16 (the precision
below the float32 the port states) instead of the program."""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import compare
from reference.gbuffer import gbuffer
from reference.pathtrace import radiance
from reference.scene import RefScene
from reference.shading import camera_frame

F64 = torch.float64
CONTROL = torch.bfloat16


def ref_scene(sess, frame, dtype):
    """The reference scene the program should hold at `frame` of a frame
    loop: an animated scene at t = frame / 60, its motion taken from the
    previous frame's time (frame 0: the scene as built)."""
    if sess.animated:
        return RefScene(sess.recipe, frame / 60.0,
                        (frame - 1) / 60.0 if frame > 0 else None, True,
                        dtype, sess.device)
    return RefScene(sess.recipe, None, None, False, dtype, sess.device)


def ref_camera(sess, dtype):
    cam = sess.recipe.camera
    pos, m = camera_frame(cam["position"], cam["target"], dtype, sess.device)
    return {"position": pos, "frame": m,
            "fov_y": math.radians(cam["fov_y_deg"])}


def sample_pixels(rng, count, sess):
    n = sess.width * sess.height
    pix = np.sort(rng.choice(n, size=min(count, n), replace=False))
    return torch.as_tensor(pix, dtype=torch.int64, device=sess.device)


def program_gbuffer(gb, pixels):
    """The program's G-buffer planes at `pixels` (row-major ids)."""
    out = {}
    for key in ("position", "normal", "geom_normal", "albedo", "emittance",
                "motion", "depth", "unit", "material", "hit"):
        plane = getattr(gb, key)
        h, w = plane.shape[:2]
        out[key] = plane.reshape(h * w, *plane.shape[2:])[pixels]
    return out


def gbuffer_check(sess, gb, frame, pixels, jitter, control):
    cam64 = ref_camera(sess, F64)
    ref = gbuffer(ref_scene(sess, frame, F64), cam64, sess.width,
                  sess.height, pixels, frame, jitter)
    if control:
        cand = gbuffer(ref_scene(sess, frame, CONTROL),
                       ref_camera(sess, CONTROL), sess.width, sess.height,
                       pixels, frame, jitter)
    else:
        cand = program_gbuffer(gb, pixels)
    return compare.gbuffer_mismatch_share(cand, ref)


def radiance_check(sess, lighting, frame, pixels, cfg, control):
    """Share of `pixels` whose one-sample radiance of `frame` is off."""
    ref = radiance(ref_scene(sess, frame, F64), ref_camera(sess, F64),
                   sess.width, sess.height, pixels, frame,
                   cfg["max_path_length"], cfg["jitter"])
    if control:
        cand = radiance(ref_scene(sess, frame, CONTROL),
                        ref_camera(sess, CONTROL), sess.width, sess.height,
                        pixels, frame, cfg["max_path_length"],
                        cfg["jitter"])
    else:
        cand = lighting.reshape(-1, 3)[pixels]
    return compare.mismatch_share(cand, ref)


def _vertices(p0, e1, e2):
    return torch.stack([p0, p0 + e1, p0 + e2], 1).reshape(-1, 9)


def scene_check(sess, scene, frame, control):
    """Largest distance (scene units) between a vertex of the program's
    world triangles after the frame's update and the reference's: each of
    the program's triangles is matched, within its instance, to the
    reference triangle with the nearest centroid, and a matching that is
    not one to one counts as infinitely far."""
    ref = ref_scene(sess, frame, F64)
    r_inst = ref.unit_instance[ref.unit]
    r_v = _vertices(ref.p0, ref.e1, ref.e2)
    if control:
        c = ref_scene(sess, frame, CONTROL)
        return float((_vertices(c.p0, c.e1, c.e2).to(F64) - r_v).abs().max())
    tris = scene.triangles
    p_inst = scene.object_triangles.instance.to(torch.int64)
    p_v = _vertices(tris.p0, tris.e1, tris.e2).to(F64)
    worst = 0.0
    for i in range(int(r_inst.max()) + 1):
        a, b = p_v[p_inst == i], r_v[r_inst == i]
        if a.shape[0] != b.shape[0]:
            return math.inf
        ca = a.reshape(-1, 3, 3).mean(1)
        cb = b.reshape(-1, 3, 3).mean(1)
        j = torch.cdist(ca, cb).argmin(1)
        if torch.unique(j).numel() != j.numel():
            return math.inf
        worst = max(worst, float((a - b[j]).abs().max()))
    return worst


def film_capture(store, colour):
    """The frame's output at the film pixels, gathered on the device
    without a wait (one small kernel a frame)."""
    pix = store["film_pixels"]
    if pix.numel():
        store.setdefault("film_samples", []).append(
            colour.reshape(-1, 3)[pix])


def film_check(store, film, control):
    """Share of the film pixels where the film the loop returned is not
    the mean of every frame's output there (all of them when it did not
    take every frame)."""
    samples = torch.stack(store["film_samples"]).to(F64)
    ref = samples.mean(0)
    if control:
        cand = torch.zeros_like(ref, dtype=CONTROL)
        for i, x in enumerate(samples):
            w = 1.0 / (1.0 + i)
            cand = (1.0 - w) * cand + w * x.to(CONTROL)
    elif int(film.num_accum) != samples.shape[0]:
        return 1.0
    else:
        cand = film.beauty.reshape(-1, 3)[store["film_pixels"]]
    return compare.mismatch_share(cand, ref)


def limited(traffic, values, n_checked):
    """([(name, value, limit)], frames found wrong). values: name -> the
    number at each checked frame (a list), or one number that judges them
    all (the film). A name's value is its worst frame's; a checked frame
    is wrong where any of its numbers exceeds the traffic mix's limit."""
    rows, wrong = [], set()
    for k, v in values.items():
        per = v if isinstance(v, list) else [v] * n_checked
        lim = traffic["limits"][k]
        wrong |= {i for i, x in enumerate(per) if not x <= lim}
        rows.append((k, max(per), lim))
    return rows, len(wrong)
