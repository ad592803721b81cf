"""gbuffer_ms: mean fenced wall time of the frame loop's `gbuffer` pass over
the window's frames, in ms (none where the loop has no such pass)."""


def read(rec):
    samples = rec.passes.get("gbuffer")
    return sum(samples) / len(samples) if samples else None
