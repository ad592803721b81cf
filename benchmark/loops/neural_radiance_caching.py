"""The neural_radiance_caching app's frame loop
(gfxexp_torch.apps.neural_radiance_caching): per frame `update` on an
animated scene, one NRC sample a pixel (sample index = frame) whose paths
end in the cache read with the EMA weights (`pathTrace+infer`), then
`train_steps` Adam steps on the frame's training records (`train`), the
film the running mean of the samples. The cache starts each run from
weights drawn from the seed.

Checked at each checked frame, against reference/nrc.py in float64:
- nrc_radiance_mismatch_share: the radiance at pixels drawn from the
  seed, the reference reading the cache from the EMA of the program's
  state before the frame's `train` (the weights the render pass should
  have used, whatever weights the program passed it);
- nrc_target_mismatch_share: the training records (queries, targets,
  valid flags) of training paths drawn from the seed;
- nrc_weights_mismatch_share: the frame's Adam steps and EMA computed
  from the program's state before `train`, on the program's records in
  the program's order, against the state after (see weight_shares);
- film_mismatch_share: the film against the mean of every frame's
  sample.

A pixel or a target is judged as compare.mismatch judges it, with the
part of it that a cache read carries allowed CACHE_RTOL of itself
besides: the MLP rounds its operands to bfloat16 (8 significant bits),
and where a float32 sum rounds an operand the other way than the float64
one, the cache's output moves by a few 2^-9 of itself.
"""

from __future__ import annotations

import numpy as np
import torch

import checks
from reference import compare
from reference import nrc as ref

CACHE_RTOL = 2.0 ** -6  # of a value's cached part (four 2^-8 moves)
MLP_TOL = 0.05  # of the learning rate, for an MLP weight
TABLE_TOL = 0.5  # of the learning rate, for a hash-table entry

# the port's constants that the configuration's network must match
_PORT_FIXED = ("hash_grid", "one_blob_bins", "input_dims", "output_dims",
               "adam_b1", "adam_b2", "adam_eps", "l2")


def first_pass(sess):
    return "update" if sess.animated else "pathTrace+infer"


def _net(sess):
    return sess.cfg["nrc"]


def _cfgs(sess):
    """(NRCConfig, NRCIntegratorConfig) of the configuration and traffic;
    raises where the configuration's network is not the one the port
    implements."""
    from gfxexp_torch.techniques.nrc import encoding as enc
    from gfxexp_torch.techniques.nrc import network
    from gfxexp_torch.techniques.nrc.cache import NRCIntegratorConfig
    from gfxexp_torch.techniques.nrc.network import NRCConfig

    net, s = _net(sess), sess.traffic["settings"]
    cfg = NRCConfig(position_encoding=net["position_encoding"],
                    num_hidden_layers=net["num_hidden_layers"],
                    learning_rate=net["learning_rate"],
                    ema_decay=net["ema_decay"], width=net["width"])
    port = {"hash_grid": {"levels": enc.HASH_LEVELS,
                          "features_per_level": enc.HASH_FEATURES,
                          "log2_hashmap_size": enc.LOG2_HASH_SIZE,
                          "base_resolution": enc.HASH_BASE_RES,
                          "per_level_scale": enc.HASH_PER_LEVEL_SCALE},
            "one_blob_bins": enc.ONE_BLOB_BINS,
            "input_dims": network.NUM_INPUT_DIMS,
            "output_dims": network.NUM_OUTPUT_DIMS,
            "adam_b1": network.ADAM_B1, "adam_b2": network.ADAM_B2,
            "adam_eps": cfg.adam_eps, "l2": network.WEIGHT_DECAY}
    wrong = [k for k in _PORT_FIXED if net[k] != port[k]]
    if wrong or not net["reflectance_factorization"]:
        raise ValueError(f"the port's NRC differs from the configuration "
                         f"in {wrong or ['reflectance_factorization']}")
    icfg = NRCIntegratorConfig(
        max_path_length=net["max_path_length"],
        train_stride=s["train_stride"],
        unbiased_fraction=net["unbiased_fraction"],
        enable_jitter=s["jitter"],
        use_reflectance_factorization=net["reflectance_factorization"])
    return cfg, icfg


def run(sess, frames, timer):
    from gfxexp_torch.apps.neural_radiance_caching import frame_loop
    from gfxexp_torch.techniques.nrc import init_nrc
    from gfxexp_torch.techniques.nrc.cache import scene_aabb

    cfg, icfg = _cfgs(sess)
    state = init_nrc(torch.Generator().manual_seed(sess.seed), cfg,
                     sess.device)
    return frame_loop(sess.scene, sess.bvh, sess.camera, sess.controllers,
                      sess.traversal, sess.width, sess.height, frames, icfg,
                      cfg, state, scene_aabb(sess.scene), timer,
                      train_steps=sess.traffic["settings"]["train_steps"])


def capture(sess, store, frame, name, args, out, checked):
    if name == "pathTrace+infer":
        checks.film_capture(store, out[0])
    if not checked:
        return
    d = store.setdefault(frame, {})
    if name == "update":
        d["scene"] = out[0]
    elif name == "pathTrace+infer":
        d["radiance"], d["tq"], d["tt"], d["tm"] = out
    elif name == "train":
        d["before"], (d["after"], d["loss"]) = args[0], out


def _params(tree, dt):
    return {"weights": [w.to(dt) for w in tree["weights"]],
            "hash_table": tree["hash_table"].to(dt)}


def _state(state, dt):
    return {"params": _params(state["params"], dt),
            "ema": _params(state["ema"], dt),
            "mu": _params(state["opt"]["mu"], dt),
            "nu": _params(state["opt"]["nu"], dt),
            "count": int(state["opt"]["count"])}


def _icfg(sess):
    s = sess.traffic["settings"]
    return {"train_stride": s["train_stride"], "jitter": s["jitter"],
            "unbiased_fraction": _net(sess)["unbiased_fraction"]}


def _reference(sess, d, frame, pixels, dt):
    """ref.sample at `pixels`, the cache read from the EMA of the state
    that the frame's `train` received: the state the render pass ran
    beside."""
    return ref.sample(checks.ref_scene(sess, frame, dt),
                      checks.ref_camera(sess, dt), sess.width, sess.height,
                      pixels, frame, _params(d["before"]["ema"], dt),
                      _net(sess), _icfg(sess))


def mismatch(cand, want, cached):
    """[P] bool: the values [P, C] off by compare.mismatch's test, each
    allowed CACHE_RTOL of its cached part `cached` besides; all values
    off where the candidate is not finite."""
    n = want.shape[0]
    cand, want, cached = (x.to(checks.F64).reshape(n, -1)
                          for x in (cand, want, cached))
    mag = want.abs().amax(-1)
    allowed = (compare.RTOL * (mag + 0.01 * mag.mean() + 1e-30)
               + CACHE_RTOL * cached.abs().amax(-1))
    return ~((cand - want).abs().amax(-1) <= allowed)


def radiance_check(sess, d, frame, pixels, control):
    """Share of `pixels` whose NRC sample is off."""
    want, cached, _ = _reference(sess, d, frame, pixels, checks.F64)
    cand = (_reference(sess, d, frame, pixels, checks.CONTROL)[0] if control
            else d["radiance"].reshape(-1, 3)[pixels])
    return compare.share(mismatch(cand, want, cached))


def _row_pixels(sess, frame, rows):
    """The pixels of training rows' lanes: lane and pixel are one on the
    frames the reference follows (ref.lane_of_pixel)."""
    stride = sess.traffic["settings"]["train_stride"]
    return frame % stride + stride * rows


def target_check(sess, d, frame, rows, control):
    """Share of the training paths `rows` whose records (queries, targets,
    valid flags) are off."""
    pix = _row_pixels(sess, frame, rows)
    want = _reference(sess, d, frame, pix, checks.F64)[2]
    if control:
        cand = _reference(sess, d, frame, pix, checks.CONTROL)[2]
    else:
        L = _net(sess)["max_path_length"]
        cand = {"query": d["tq"].reshape(-1, L, 14)[rows],
                "target": d["tt"].reshape(-1, L, 3)[rows],
                "valid": d["tm"].reshape(-1, L)[rows]}
    bad = (cand["valid"] != want["valid"]).any(-1)
    bad |= compare.mismatch(cand["query"].reshape(len(rows), -1),
                            want["query"].reshape(len(rows), -1))
    bad |= mismatch(cand["target"], want["target"], want["target_cached"])
    return compare.share(bad)


def _off(cand, want, tol):
    """(entries of `want` off by more than tol, entries)."""
    return (sum(int((~((a.to(checks.F64) - b).abs() <= tol)).sum())
                for a, b in zip(cand, want)), sum(b.numel() for b in want))


def weight_shares(sess, d, frame, control):
    """The frame's training from the program's state before it, against
    the program's state after it:
    - mlp: the share of MLP weights (parameters and EMA) off by more than
      MLP_TOL x lr;
    - table: the largest share of hash-table entries (parameters and EMA)
      off by more than TABLE_TOL x lr, among the entries of each level that
      the frame's records gave a gradient, and among those they gave none
      (which weight decay alone moves). With eps 1e-15 Adam moves an entry
      by about lr whatever the size of its gradient, so an entry whose
      gradient sums to nearly 0 moves by up to 2 lr on the order its terms
      add in: the table is judged by shares;
    - loss: 1 where the frame's loss is off by more than compare.RTOL,
      else 0."""
    net = _net(sess)
    steps = sess.traffic["settings"]["train_steps"]
    perm = ref.permutation(d["tq"].shape[0], frame)

    def train(dt):
        return ref.train_frame(_state(d["before"], dt), d["tq"].to(dt),
                               d["tt"].to(dt), d["tm"], perm, steps, net)

    want, want_loss, touched = train(checks.F64)
    if control:
        cand, loss, _ = train(checks.CONTROL)
    else:
        cand = {k: _params(d["after"][k], checks.F64)
                for k in ("params", "ema")}
        loss = d["loss"]
    parts = ("params", "ema")
    lr = net["learning_rate"]
    off, count = _off([w for k in parts for w in cand[k]["weights"]],
                      [w for k in parts for w in want[k]["weights"]],
                      MLP_TOL * lr)
    out = {"mlp": off / count, "table": 0.0}
    # per level the entries with a gradient, then those without
    off = sum((~((cand[k]["hash_table"].to(checks.F64)
                  - want[k]["hash_table"]).abs() <= TABLE_TOL * lr)).to(
                      torch.int64) for k in parts).sum(-1)
    count = 2 * want["params"]["hash_table"].shape[-1]
    for lv in range(touched.shape[0]):
        for group in (touched[lv], ~touched[lv]):
            if group.any():
                out["table"] = max(out["table"], int(off[lv][group].sum())
                                   / (count * int(group.sum())))
    out["loss"] = float(not (abs(float(loss) - float(want_loss))
                             <= compare.RTOL * abs(float(want_loss))))
    return out


def weights_check(sess, d, frame, control):
    """The largest of weight_shares."""
    return max(weight_shares(sess, d, frame, control).values())


def check(sess, store, frames, rng, control):
    pix = checks.sample_pixels(rng, sess.traffic["check_pixels"], sess)
    n_train = (sess.width * sess.height
               // sess.traffic["settings"]["train_stride"])
    rows = torch.as_tensor(np.sort(rng.choice(
        n_train, size=min(sess.traffic["check_train_rows"], n_train),
        replace=False)), dtype=torch.int64, device=sess.device)
    values = {
        "nrc_radiance_mismatch_share": [
            radiance_check(sess, store[f], f, pix, control) for f in frames],
        "nrc_target_mismatch_share": [
            target_check(sess, store[f], f, rows, control) for f in frames],
        "nrc_weights_mismatch_share": [
            weights_check(sess, store[f], f, control) for f in frames],
        "film_mismatch_share": checks.film_check(store, store["result"][0],
                                                 control)}
    if sess.animated:
        values["scene_max_error"] = [
            checks.scene_check(sess, store[f]["scene"], f, control)
            for f in frames]
    return checks.limited(sess.traffic, values, len(frames))
