"""walk_roofline: the least time the stretch's walk launches need (their
rays and tables read once and hits written once at the HBM bandwidth,
yardstick.walk_bound_s) as a share of the walk kernels' device time, in %."""

import yardstick


def read(rec):
    if not rec.kernels or not rec.walk_calls:
        return None
    dev_s = sum(e - s for name, s, e in rec.kernels
                if yardstick.is_walk(name)) * 1e-6
    if dev_s <= 0:
        return None
    bound = sum(yardstick.walk_bound_s(n, b) for n, b in rec.walk_calls)
    return 100.0 * bound / dev_s
