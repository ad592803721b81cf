"""idle_share: the share of the traced stretch's wall time in which no
operation ran on the device: 1 - (union of the device's operation
intervals in the stretch) / (the stretch's wall time), the two taken from
the same frames. The profiler slows the host that launches the work, so
the share reads above that of an untraced frame."""

import yardstick


def read(rec):
    if not rec.kernels or rec.stretch_wall_s <= 0:
        return None
    busy = sum(e - s for s, e in yardstick.busy_union(
        [(s, e) for _, s, e in rec.kernels])) * 1e-6
    return 1.0 - busy / rec.stretch_wall_s
