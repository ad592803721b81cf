"""The NRC cell on the CPU at a tiny frame: a run comes out correct, and
with a fault planted in the port's cache it comes out not correct, caught
by the number that judges the broken part: the EMA left out of the
optimizer step, one hash-grid level's features zeroed, three training
steps a frame instead of four, the frame loop's render pass reading the
cache with the parameters in place of their EMA.

The frame is 48x27: at 32x18 a stride of 32 lanes leaves 18 training
paths, all in one column left of the box, so that no record is valid and
the cache never trains; at 48x27 the training lanes fall in three columns
of the frame, two of them on the box."""

import inspect
import io
import textwrap

import pytest
import torch

CELL = "cornellbox.nrc_hashgrid"
SIZE = (48, 27)


def _ema_left_out(fn):
    def f(state, grads, cfg):
        new = fn(state, grads, cfg)
        new["ema"] = state["ema"]
        return new
    return f


def _level_zeroed(fn):
    def f(table, p):
        out = fn(table, p).clone()
        out[..., 14:16] = 0.0  # level 7's two features
        return out
    return f


def _three_steps(fn):
    def f(state, query, target, mask, cfg, steps=4, generator=None,
          perm=None):
        return fn(state, query, target, mask, cfg, 3, generator, perm)
    return f


def _infers_with_params(fn):
    """The frame loop, its render pass given state["params"] where it
    passes state["ema"]."""
    src = textwrap.dedent(inspect.getsource(fn))
    old = 'state["ema"], lo, hi'
    assert src.count(old) == 1
    scope = dict(fn.__globals__)
    exec(src.replace(old, 'state["params"], lo, hi'), scope)
    return scope[fn.__name__]


NRC = "gfxexp_torch.techniques.nrc"
FAULTS = [
    (f"{NRC}.network.apply_step", _ema_left_out,
     "nrc_weights_mismatch_share"),
    (f"{NRC}.encoding.hash_grid_encoding", _level_zeroed,
     "nrc_weights_mismatch_share"),
    (f"{NRC}.train_on_frame", _three_steps, "nrc_weights_mismatch_share"),
    ("gfxexp_torch.apps.neural_radiance_caching.frame_loop",
     _infers_with_params, "nrc_radiance_mismatch_share"),
]


def _run():
    import harness

    rc, res = harness.run_cell(CELL, 2147483659, 0.2, False, device="cpu",
                               size=SIZE, out=io.StringIO(),
                               err=io.StringIO())
    assert rc == 0
    return res


def test_cell_correct_on_cpu():
    res = _run()
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {
        "nrc_radiance_mismatch_share", "nrc_target_mismatch_share",
        "nrc_weights_mismatch_share", "film_mismatch_share"}
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}


@pytest.mark.parametrize("target,fault,caught_by", FAULTS,
                         ids=[f[1].__name__ for f in FAULTS])
def test_fault_makes_run_incorrect(target, fault, caught_by, monkeypatch):
    import importlib

    mod, attr = target.rsplit(".", 1)
    m = importlib.import_module(mod)
    monkeypatch.setattr(m, attr, fault(getattr(m, attr)))
    res = _run()
    assert res["correct"] is False
    check = res["checks"][caught_by]
    assert not check["value"] <= check["limit"], (caught_by, check)
    assert torch.get_default_dtype() == torch.float32
