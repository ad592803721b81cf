"""walk_ms: device time of the ray walk kernels a frame of the traced
stretch, in ms, from the profiler's device trace."""

import yardstick


def read(rec):
    if not rec.kernels or not rec.stretch_frames:
        return None
    us = sum(e - s for name, s, e in rec.kernels if yardstick.is_walk(name))
    return us * 1e-3 / rec.stretch_frames if us > 0 else None
