"""nrc_train_ms: mean fenced wall time of the frame loop's `train` pass
(the cache's Adam steps and EMA on the frame's records) over the window's
frames, in ms (none where the loop has no such pass)."""


def read(rec):
    samples = rec.passes.get("train")
    return sum(samples) / len(samples) if samples else None
