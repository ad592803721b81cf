"""nrc_train_roofline: the least time the `train` pass's work needs
(nrc_yardstick.train_bound_s: its bytes at the HBM bandwidth or its
operations at the dense bfloat16 tensor peak, whichever is longer) as a
share of the pass's fenced mean time, in %. The work a frame is read from
the port's counters alone (records, parameters updated and forward
multiply-adds, over the frames trained); none where the port counts no
such work."""

import nrc_yardstick


def read(rec):
    samples = rec.passes.get("train")
    work = nrc_yardstick.counted_work()
    if not samples or work is None:
        return None
    bound = nrc_yardstick.train_bound_s(*work)
    return 100.0 * bound / (sum(samples) / len(samples) * 1e-3)
