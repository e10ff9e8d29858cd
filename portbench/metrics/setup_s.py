"""Process start to the first timed request: imports, kernel builds
(cached in build/torch_kernels after the first run), weights, set-up
solves and the warm-up serve."""
NAME, UNIT = "setup_s", "s"


def read(rec):
    return rec.setup_s
