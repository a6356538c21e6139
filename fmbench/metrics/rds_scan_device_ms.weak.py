"""RDS scan decoders: the kernel milliseconds a block that the scan
decoder's call launches (the program's span `rx.rds_scan`, a profiler
range while the attribution pass records), from the eager attribution
pass.  A program without the span gives nothing."""


def read(view):
    a = view.attribution
    if not a or not a.get("rx.rds_scan") or not view.attribution_blocks:
        return None
    return a["rx.rds_scan"] * 1e-3 / view.attribution_blocks
