"""setup_s: process start to the end of the warm-up frames (imports, the
device's context, the kernels' build or cache, the scene, the warm-up), in
s."""


def read(rec):
    return rec.setup_s
