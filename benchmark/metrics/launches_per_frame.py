"""launches_per_frame: device kernels (copies and fills left out) a frame
of the traced stretch, from the profiler's device trace."""

import yardstick


def read(rec):
    if not rec.kernels or not rec.stretch_frames:
        return None
    n = sum(1 for name, _, _ in rec.kernels if yardstick.is_kernel(name))
    return n / rec.stretch_frames
