"""restir_ms: mean fenced wall time of the frame loop's `restir` pass over
the window's frames, in ms (none where the loop has no such pass)."""


def read(rec):
    samples = rec.passes.get("restir")
    return sum(samples) / len(samples) if samples else None
