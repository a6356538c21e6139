"""The live traffic's generator process: it writes a byte stream into a
pipe in chunks on a fixed schedule that does not slow when the reader
does.

    python fmbench/pacer.py

Its standard input carries one JSON line {"fd", "chunk_bytes",
"period_s", "total_bytes"}, then the stream's total_bytes, then a line
"go <t0>" where t0 is a time.monotonic() value (the clock is shared by
the processes of one machine).  Chunk i is written once its last frame is
due, at t0 + (i + 1) * period_s: the generator sleeps until SPIN_S before
that and spins the rest, so that a sleep's wake-up jitter does not delay
the write.  It answers "ready" on its standard output once it holds the
stream, and, when every chunk is written and the pipe closed, one JSON
line: the time each chunk was offered to the pipe (`offered`), and how
late those times were against the schedule.
"""

from __future__ import annotations

import json
import os
import sys
import time

SPIN_S = 0.001


def main() -> int:
    stdin = sys.stdin.buffer
    head = json.loads(stdin.readline())
    fd, chunk = int(head["fd"]), int(head["chunk_bytes"])
    period, total = float(head["period_s"]), int(head["total_bytes"])
    data = bytearray(total)
    view = memoryview(data)
    got = 0
    while got < total:
        n = stdin.readinto(view[got:])
        if not n:
            raise SystemExit("pacer: the stream ended early")
        got += n
    print("ready", flush=True)
    line = stdin.readline().split()
    if not line or line[0] != b"go":
        raise SystemExit("pacer: no go")
    t0 = float(line[1])
    offered = []
    for i in range(total // chunk):
        due = t0 + (i + 1) * period
        wait = due - SPIN_S - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        while time.monotonic() < due:
            pass
        offered.append(time.monotonic())
        part = view[i * chunk:(i + 1) * chunk]
        while len(part):
            part = part[os.write(fd, part):]
    os.close(fd)
    late = sorted(t - (t0 + (i + 1) * period) for i, t in enumerate(offered))
    print(json.dumps({"chunks": len(late), "offered": offered,
                      "late_ms_p50": late[len(late) // 2] * 1e3,
                      "late_ms_p99": late[int(0.99 * (len(late) - 1))] * 1e3,
                      "late_ms_max": late[-1] * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
