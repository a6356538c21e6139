"""fm chain over the station rows: the kernel milliseconds a block that
`Receiver.fm_chain` launches on every receiver's row at once, from the
eager attribution pass (each kernel to the harness range that queued
it)."""


def read(view):
    a = view.attribution
    if not a or not a.get("fm_chain") or not view.attribution_blocks:
        return None
    return a["fm_chain"] * 1e-3 / view.attribution_blocks
