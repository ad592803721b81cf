"""nrc_render_ms: mean fenced wall time of the frame loop's
`pathTrace+infer` pass (the NRC sample: its paths, the cache's inference
at their ends, the training targets) over the window's frames, in ms
(none where the loop has no such pass)."""


def read(rec):
    samples = rec.passes.get("pathTrace+infer")
    return sum(samples) / len(samples) if samples else None
