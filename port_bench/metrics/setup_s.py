"""Set-up: process start to the first timed call (import, CUDA context,
kernel libraries, the host build, the noise pool, warm-up)."""


def read(run):
    return run.setup_s
