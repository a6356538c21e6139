"""Set-up: the seconds in the captures of the step's CUDA graphs
(`setup.capture`: warm-up steps, capture and instantiation), outside the
spans nested in them (a kernel library's first load), from the program's
own spans."""

from fmbench.program_spans import self_seconds


def read(view):
    return self_seconds("setup.capture")
