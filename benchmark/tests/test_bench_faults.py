"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (device="cpu", a tiny frame) and the
rest of a run is driven with one fault planted in the port's functions
each time: a step that hands its state on unchanged (ReSTIR's
reservoirs, SVGF's history, the film), half of the pixels left out, and
an answer altered where it is produced. (An animated scene handed on
unchanged is test_bench_extension's: no cell animates its scene.)"""

import json
import os

import pytest
import torch

from conftest import ROOT

BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _restir_state_unchanged(fn):
    def f(scene, bvh, gb, camera, prev_res, *a, **kw):
        color, res, ctx, vis = fn(scene, bvh, gb, camera, prev_res, *a, **kw)
        return color, prev_res, ctx, vis
    return f


def _restir_scaled(fn):
    def f(*a, **kw):
        color, res, ctx, vis = fn(*a, **kw)
        return color * 1.01, res, ctx, vis
    return f


def _svgf_state_unchanged(fn):
    def f(state, *a, **kw):
        return fn(state, *a, **kw)[0], state
    return f


def _svgf_scaled(fn):
    def f(*a, **kw):
        final, state = fn(*a, **kw)
        return final * 1.01, state
    return f


def _restir_half_dark(fn):
    def f(*a, **kw):
        color, res, ctx, vis = fn(*a, **kw)
        color = color.clone()
        color.reshape(-1, 3)[color.reshape(-1, 3).shape[0] // 2:] = 0.0
        return color, res, ctx, vis
    return f


def _half_dark(fn):
    def f(*a, **kw):
        out = fn(*a, **kw).clone()
        out.reshape(-1, 3)[out.reshape(-1, 3).shape[0] // 2:] = 0.0
        return out
    return f


def _scaled(fn):
    def f(*a, **kw):
        return fn(*a, **kw) * 1.01
    return f


def _film_unchanged(fn):
    def f(film, *a, **kw):
        return film
    return f


RESTIR = "gfxexp_torch.techniques.restir_di.restir_di_frame"
SVGF = "gfxexp_torch.techniques.svgf.svgf_frame"
SAMPLE = "gfxexp_torch.render.pathtrace.render_sample"
FILM = "gfxexp_torch.render.film.add_sample"
FAULTS = {
    "cornellbox.restir_rearch": [
        (RESTIR, _restir_state_unchanged, "restir_mismatch_share"),
        (RESTIR, _restir_scaled, "restir_mismatch_share"),
        (RESTIR, _restir_half_dark, "restir_mismatch_share"),
        (FILM, _film_unchanged, "film_mismatch_share")],
    "cornellbox.svgf": [
        (SVGF, _svgf_state_unchanged, "svgf_mismatch_share"),
        (SVGF, _svgf_scaled, "svgf_mismatch_share"),
        (SAMPLE, _half_dark, "radiance_mismatch_share"),
        (SAMPLE, _scaled, "radiance_mismatch_share")],
    "cornellbox.pt": [
        (SAMPLE, _half_dark, "radiance_mismatch_share"),
        (SAMPLE, _scaled, "radiance_mismatch_share"),
        (FILM, _film_unchanged, "film_mismatch_share")],
}
CASES = [(w, *f) for w, faults in FAULTS.items() for f in faults]


@pytest.mark.parametrize("workload,target,fault,caught_by", CASES,
                         ids=[f"{c[0]}-{c[2].__name__}" for c in CASES])
def test_fault_makes_run_incorrect(workload, target, fault, caught_by,
                                   monkeypatch):
    import importlib
    import io

    import harness

    mod, attr = target.rsplit(".", 1)
    m = importlib.import_module(mod)
    monkeypatch.setattr(m, attr, fault(getattr(m, attr)))
    out = io.StringIO()
    rc, res = harness.run_cell(workload, 2147483653, 0.2, False,
                               device="cpu", size=(32, 18), out=out,
                               err=io.StringIO())
    assert rc == 0
    assert res["correct"] is False
    value, limit = (res["checks"][caught_by]["value"],
                    res["checks"][caught_by]["limit"])
    assert not value <= limit, (caught_by, value, limit)
    assert torch.get_default_dtype() == torch.float32
