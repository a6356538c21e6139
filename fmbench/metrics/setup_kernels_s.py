"""Set-up: the seconds the process spent loading the program's native
libraries (`setup.kernel_load`: the CUDA kernels' and the ingest
library's, each built first where its build is missing), from the
program's own spans."""

from fmbench.program_spans import self_seconds


def read(view):
    return self_seconds("setup.kernel_load")
