"""frame_ms: the window's wall time, from its first frame's first pass to
the synchronize after its last frame, over the frames it completed, in
ms."""


def read(rec):
    return rec.window_s * 1e3 / rec.frames
