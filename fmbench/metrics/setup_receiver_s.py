"""Set-up: the seconds in `Receiver` construction (`setup.receiver`: the
host designs and the constants on the device), outside the spans nested
in it, from the program's own spans."""

from fmbench.program_spans import self_seconds


def read(view):
    return self_seconds("setup.receiver")
