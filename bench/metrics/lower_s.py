"""The seconds ``lower_pipeline`` took in set-up, with the load (or
build) of each megakernel's library: the DSE (from the tuning cache
when warm), the source, nvcc on a checkout's first run."""


def read(rec):
    return rec.lower_s
