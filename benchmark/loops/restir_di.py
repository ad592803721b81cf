"""The restir_di app's frame loop (gfxexp_torch.apps.restir_di): per frame
`update` on an animated scene, the G-buffer (`gbuffer`, sample index =
frame) and one ReSTIR DI frame (`restir`), into the film's running mean.
Checked at each checked frame: the G-buffer at pixels drawn from the
seed, and the resampled image and the reservoirs handed to the next frame
at pixels drawn from the seed, computed by the reference from the
previous frame's reservoirs the program carried (none at frame 0, which
the reference computes from nothing but the scene); and the film the loop
returns against the mean of every frame's image at pixels drawn from the
seed."""

from __future__ import annotations

import checks
from reference import compare
from reference.restir import FIELDS, restir_frame

def first_pass(sess):
    return "update" if sess.animated else "gbuffer"


def _cfg(sess):
    from gfxexp_torch.techniques.restir_di import ReSTIRConfig

    s = sess.traffic["settings"]
    return ReSTIRConfig(**{k: s[k] for k in (
        "log2_num_candidates", "enable_temporal_reuse",
        "enable_spatial_reuse", "num_spatial_passes",
        "num_spatial_neighbors", "spatial_radius",
        "use_rearchitected_pipeline", "num_light_subsets",
        "light_subset_size")})


def run(sess, frames, timer):
    from gfxexp_torch.apps.restir_di import frame_loop

    return frame_loop(sess.scene, sess.bvh, sess.camera, sess.controllers,
                      sess.traversal, sess.width, sess.height, frames,
                      _cfg(sess), sess.traffic["settings"]["jitter"], timer)


def capture(sess, store, frame, name, args, out, checked):
    if name == "restir":
        checks.film_capture(store, out[0])
    if not checked:
        return
    d = store.setdefault(frame, {})
    if name == "gbuffer":
        d["gb"] = out
    elif name == "restir":
        d["prev_res"] = args[4]
        d["color"] = out[0]
        d["res"] = out[1]


def restir_check(sess, d, frame, pixels, control):
    s = sess.traffic["settings"]
    prev = None
    if frame > 0:
        prev = {k: getattr(d["prev_res"], k) for k in FIELDS}
    prev_sample = frame - 1 if frame > 0 else 0
    ref, ref_res = restir_frame(
        checks.ref_scene(sess, frame, checks.F64),
        checks.ref_camera(sess, checks.F64), sess.width, sess.height, pixels,
        frame, prev_sample, prev, s)
    if control:
        cand, cand_res = restir_frame(
            checks.ref_scene(sess, frame, checks.CONTROL),
            checks.ref_camera(sess, checks.CONTROL), sess.width, sess.height,
            pixels, frame, prev_sample, prev, s)
    else:
        cand = d["color"].reshape(-1, 3)[pixels]
        cand_res = {k: getattr(d["res"], k)[pixels] for k in FIELDS}
    return compare.share(compare.mismatch(cand, ref)
                         | compare.fields_mismatch(cand_res, ref_res))


def check(sess, store, frames, rng, control):
    s = sess.traffic["settings"]
    pix = checks.sample_pixels(rng, sess.traffic["check_pixels"], sess)
    gpix = checks.sample_pixels(rng, sess.traffic["check_gbuffer_pixels"],
                                sess)
    values = {
        "gbuffer_mismatch_share": [
            checks.gbuffer_check(sess, store[f]["gb"], f, gpix, s["jitter"],
                                 control) for f in frames],
        "restir_mismatch_share": [
            restir_check(sess, store[f], f, pix, control) for f in frames],
        "film_mismatch_share": checks.film_check(
            store, store["result"][0], control)}
    return checks.limited(sess.traffic, values, len(frames))
