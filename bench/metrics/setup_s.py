"""Process start to the window's start: imports, the CUDA context, the
data, the lowering (DSE, source, build or load) and the warm-up."""


def read(rec):
    return rec.setup_s
