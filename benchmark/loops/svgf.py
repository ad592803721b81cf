"""The svgf app's frame loop (gfxexp_torch.apps.svgf): per frame `update`
on an animated scene, the G-buffer (`gbuffer`, sample index = frame), one
path-traced sample (`pathTrace`) and its SVGF filtering with TAA
(`svgf`). Checked at each checked frame: the animated scene after
`update`, the G-buffer and the radiance at pixels drawn from the seed,
and the whole filtered image and the history handed to the next frame,
computed by the reference from the program's history and the frame's
G-buffer and radiance (each of which is checked against the reference
itself)."""

from __future__ import annotations


import checks
from reference import compare
from reference.svgf import svgf_frame

_STATE = ("prev_noisy", "moments", "sample_count", "prev_position",
          "prev_normal", "prev_unit", "prev_material", "taa_history",
          "first_frame")
_GB = ("position", "normal", "albedo", "motion", "depth", "unit",
       "material", "hit")


def first_pass(sess):
    return "update" if sess.animated else "gbuffer"


def _cfgs(sess):
    from gfxexp_torch.render.pathtrace import PTConfig
    from gfxexp_torch.techniques.svgf import SVGFConfig

    s = sess.traffic["settings"]
    return (PTConfig(max_path_length=s["max_path_length"],
                     enable_jitter=s["jitter"]),
            SVGFConfig(num_filter_stages=s["filter_stages"]))


def run(sess, frames, timer):
    from gfxexp_torch.apps.svgf import frame_loop

    pt, sv = _cfgs(sess)
    return frame_loop(sess.scene, sess.bvh, sess.camera, sess.controllers,
                      sess.traversal, sess.width, sess.height, frames, pt,
                      sv, timer)


def capture(sess, store, frame, name, args, out, checked):
    if not checked:
        return
    d = store.setdefault(frame, {})
    if name == "update":
        d["scene"] = out[0]
    elif name == "gbuffer":
        d["gb"] = out
    elif name == "pathTrace":
        d["lighting"] = out
    elif name == "svgf":
        d["state"] = args[0]
        d["final"], d["new_state"] = out


def _cast(x, dt):
    return x.to(dt) if x.is_floating_point() else x


def svgf_check(sess, d, control):
    dt = checks.CONTROL if control else checks.F64
    state = {k: getattr(d["state"], k) for k in _STATE}
    gb = {k: getattr(d["gb"], k) for k in _GB}
    light = d["lighting"].reshape(sess.height, sess.width, 3)
    stages = sess.traffic["settings"]["filter_stages"]
    ref, ref_hist = svgf_frame(
        {k: _cast(v, checks.F64) for k, v in state.items()},
        {k: _cast(v, checks.F64) for k, v in gb.items()},
        light.to(checks.F64), stages)
    if control:
        cand, cand_hist = svgf_frame(
            {k: _cast(v, dt) for k, v in state.items()},
            {k: _cast(v, dt) for k, v in gb.items()}, light.to(dt), stages)
    else:
        cand = d["final"]
        cand_hist = {k: getattr(d["new_state"], k) for k in ref_hist}
    n = sess.width * sess.height
    flat = {k: v.reshape(n, -1) for k, v in ref_hist.items()}
    return compare.share(
        compare.mismatch(cand.reshape(n, 3), ref.reshape(n, 3))
        | compare.fields_mismatch({k: v.reshape(n, -1)
                                   for k, v in cand_hist.items()}, flat))


def check(sess, store, frames, rng, control):
    s = sess.traffic["settings"]
    pix = checks.sample_pixels(rng, sess.traffic["check_pixels"], sess)
    gpix = checks.sample_pixels(rng, sess.traffic["check_gbuffer_pixels"],
                                sess)
    values = {
        "gbuffer_mismatch_share": [
            checks.gbuffer_check(sess, store[f]["gb"], f, gpix, s["jitter"],
                                 control) for f in frames],
        "radiance_mismatch_share": [
            checks.radiance_check(sess, store[f]["lighting"], f, pix, s,
                                  control) for f in frames],
        "svgf_mismatch_share": [svgf_check(sess, store[f], control)
                                for f in frames]}
    if sess.animated:
        values["scene_max_error"] = [
            checks.scene_check(sess, store[f]["scene"], f, control)
            for f in frames]
    return checks.limited(sess.traffic, values, len(frames))
