"""spans.py attributes device operations to the port's spans: on a
synthetic stretch, an operation launched inside nested spans counts once
under each enclosing name, one launched outside every span under none,
the device's idle time goes to the span whose launch ended it, a
device-side `gfx.*` annotation is no operation, and walk kernels that no
launch claims pair with the walk spans in time order. A traced CPU run of
each cell, with the program's spans recording, still reports what it
reported."""

import io

import pytest

import spans as S

MARKS = {"gbuffer", "restir"}


def _stretch():
    """Two frames' worth of spans (us) and operations (name, start, end,
    correlation id) with their launch times."""
    spans = S.nest([
        S.Span("gfx.restir", 0, 100), S.Span("gfx.restir.shade", 50, 90),
        S.Span("gfx.walk.any", 60, 70), S.Span("gfx.restir", 200, 300)])
    ops = [("add_kernel", 110, 120, 1),        # launched in gfx.walk.any
           ("mul_kernel", 120, 125, 2),        # launched in gfx.restir
           ("Memcpy DtoD", 130, 131, 3),       # launched in gfx.restir
           ("where_kernel", 400, 410, 4)]      # launched after every span
    launches = {1: 65, 2: 10, 3: 20, 4: 350}
    return spans, ops, launches


def test_nested_launch_counts_once_in_each_enclosing_span():
    spans, ops, launches = _stretch()
    owner = S.attribute(spans, ops, launches)
    assert [spans[j].name if j is not None else None for j in owner] == [
        "gfx.walk.any", "gfx.restir", "gfx.restir", None]
    t = S.per_span(spans, ops, owner, frames=2)
    assert t["gfx.walk.any"]["launches"] == 0.5
    assert t["gfx.restir.shade"]["launches"] == 0.5
    # two kernels and a copy: copies count as device time, not launches
    assert t["gfx.restir"]["launches"] == 1.0
    assert t["gfx.restir"]["device_ms"] == pytest.approx(16e-3 / 2)
    assert t["gfx.restir"]["calls"] == 1.0
    # 200 us of spans, 40 of them covered by the child
    assert t["gfx.restir"]["self_host_ms"] == pytest.approx(0.16 / 2)
    assert t["gfx.restir"]["host_ms"] == pytest.approx(0.2 / 2)
    # the device idled 5 us before the copy the span launched
    assert t["gfx.restir"]["wait_ms"] == pytest.approx(5e-3 / 2)
    assert t["gfx.walk.any"]["wait_ms"] == 0.0


def test_launch_outside_every_span_counts_in_none():
    spans, ops, launches = _stretch()
    t = S.per_span(spans, ops, S.attribute(spans, ops, launches), frames=2)
    assert t[None]["launches"] == 0.5
    assert t[None]["device_ms"] == pytest.approx(10e-3 / 2)
    assert t[None]["wait_ms"] == pytest.approx(269e-3 / 2)
    assert sum(r["launches"] for name, r in t.items()
               if name is None or name == "gfx.restir") == 1.5


def test_device_annotations_are_no_operations():
    events = [("gfx.restir", 0, 100, 9), ("restir", 0, 100, 8),
              ("gfx.walk.any", 5, 6, 7), ("add_kernel", 1, 2, 1)]
    assert S.device_ops(events, MARKS) == [("add_kernel", 1, 2, 1)]


def test_unlinked_walk_kernels_pair_with_walk_spans_in_order():
    spans = S.nest([S.Span("gfx.pathtrace", 0, 100),
                    S.Span("gfx.walk.closest", 10, 20),
                    S.Span("gfx.walk.any", 30, 40)])
    ops = [("widerow_walk_rays<true, 4>(float const*)", 300, 310, 21),
           ("widerow_walk<false, 4>(float const*)", 200, 250, 20),
           ("add_kernel", 260, 270, 22)]
    owner = S.attribute(spans, ops, {22: 50})
    assert [spans[j].name for j in owner] == [
        "gfx.walk.any", "gfx.walk.closest", "gfx.pathtrace"]


@pytest.mark.parametrize("workload", ["cornellbox.restir_rearch",
                                      "cornellbox.svgf", "cornellbox.pt"])
def test_traced_cpu_run_reports_as_before(workload):
    import harness

    rc, res = harness.run_cell(workload, 2147483711, 0.2, True,
                               device="cpu", size=(32, 18), out=io.StringIO(),
                               err=io.StringIO())
    assert rc == 0 and res["correct"]
    # the CPU profiler traces no device operation: no device_trace metric
    host = {"gbuffer_ms", "pathtrace_ms", "restir_ms", "svgf_ms",
            "frame_ms"}
    assert {m.split(".")[0] for m in res["metrics"]} <= host
    assert res["metrics"]


def test_stretch_tables_the_spans_of_each_frame():
    """A CPU stretch of the svgf cell: every layer once a frame, each of
    the path tracer's five bounces once, two walks a frame at least; no
    device operation to attribute."""
    table, summary = S.stretch("cornellbox.svgf", 2147483713, device="cpu",
                               size=(32, 18))
    for name in ("gfx.gbuffer", "gfx.pathtrace", "gfx.svgf",
                 "gfx.pathtrace.resolve", "gfx.svgf.taa",
                 *(f"gfx.pathtrace.bounce{b}" for b in range(1, 6))):
        assert table[name]["calls"] == 1.0, name
    assert table["gfx.pathtrace.bounce2.bsdf"]["calls"] == 2.0
    assert table["gfx.walk.closest"]["calls"] >= 2.0
    assert all(r["launches"] == 0 for r in table.values())
    assert 0 < table["gfx.svgf"]["self_host_ms"] < table["gfx.svgf"][
        "host_ms"]
    assert summary["ops_per_frame"] == 0 and summary["idle_share"] is None


class _Event:
    """A profiler event as the raw trace gives it."""

    def __init__(self, name, device, start_us, dur_us, corr):
        self._v = name, device, start_us * 1000, dur_us * 1000, corr

    def name(self):
        return self._v[0]

    def device_type(self):
        import torch

        return getattr(torch.autograd.DeviceType, self._v[1])

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_trace_splits_spans_launches_and_device_operations():
    """Spans by their names, launch calls by the CUDA API's names,
    device events as operations; a CPU operation whose id equals a
    launch's claims nothing."""
    events = [_Event("gfx.restir", "CPU", 0, 100, 1),
              _Event("aten::mul", "CPU", 5, 10, 7),
              _Event("cudaLaunchKernel", "CPU", 10, 2, 7),
              _Event("cuLaunchKernel", "CPU", 20, 2, 8),
              _Event("cudaMemcpyAsync", "CPU", 30, 2, 9),
              _Event("Activity Buffer Request", "CPU", 40, 2, 10),
              _Event("mul_kernel", "CUDA", 200, 5, 7),
              _Event("widerow_walk<false, 4>", "CUDA", 210, 5, 8),
              _Event("Memcpy DtoD", "CUDA", 220, 1, 9),
              _Event("restir", "CUDA", 200, 30, 11)]
    spans, ops, launches = S._from_trace(events, MARKS)
    assert [s.name for s in spans] == ["gfx.restir"]
    assert launches == {7: 10, 8: 20, 9: 30}
    assert [op[0] for op in ops] == ["mul_kernel", "widerow_walk<false, 4>",
                                     "Memcpy DtoD"]
    assert S.attribute(spans, ops, launches) == [0, 0, 0]
