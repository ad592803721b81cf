"""The path_tracing app's frame loop (gfxexp_torch.apps.path_tracing):
per frame `update` on an animated scene, then `pathTrace`, one sample a
pixel (sample index = frame), into the film's running mean. Checked: the
animated scene after `update`, and each checked frame's radiance at
pixels drawn from the seed against the reference path tracer."""

from __future__ import annotations

import checks


def first_pass(sess):
    return "update" if sess.animated else "pathTrace"


def _cfg(sess):
    from gfxexp_torch.render.pathtrace import PTConfig

    s = sess.traffic["settings"]
    return PTConfig(max_path_length=s["max_path_length"],
                    enable_jitter=s["jitter"])


def run(sess, frames, timer):
    from gfxexp_torch.apps.path_tracing import frame_loop

    return frame_loop(sess.scene, sess.bvh, sess.camera, sess.controllers,
                      sess.traversal, sess.width, sess.height, frames,
                      _cfg(sess), timer)


def capture(sess, store, frame, name, args, out, checked):
    if name == "pathTrace":
        checks.film_capture(store, out)
    if not checked:
        return
    if name == "update":
        store.setdefault(frame, {})["scene"] = out[0]
    elif name == "pathTrace":
        store.setdefault(frame, {})["lighting"] = out


def check(sess, store, frames, rng, control):
    s = sess.traffic["settings"]
    pix = checks.sample_pixels(rng, sess.traffic["check_pixels"], sess)
    values = {
        "radiance_mismatch_share": [
            checks.radiance_check(sess, store[f]["lighting"], f, pix, s,
                                  control) for f in frames],
        "film_mismatch_share": checks.film_check(store, store["result"][0],
                                                 control)}
    if sess.animated:
        values["scene_max_error"] = [
            checks.scene_check(sess, store[f]["scene"], f, control)
            for f in frames]
    return checks.limited(sess.traffic, values, len(frames))
