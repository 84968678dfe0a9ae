"""Host clock around the controller's and the entry's operator builds in
set-up (Hankel matrices, the QP, its solution map or ADMM operator, the
block map and the fused operator)."""


def read(run):
    return run.host_build_s
