"""Host clock around the kernel library's load (``ops/_kernels.py::load``:
nvcc on a checkout's first run, then the cached library)."""


def read(run):
    return run.kernel_load_s
