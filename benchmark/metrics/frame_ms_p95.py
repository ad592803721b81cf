"""frame_ms_p95: the 95th percentile of the window's frame intervals (from
a frame's first pass to the next frame's, the last closed by the final
synchronize), in ms."""

import numpy as np


def read(rec):
    return float(np.percentile(rec.intervals_ms, 95))
