"""When each test file of a pytest-xdist run starts and how long it runs.

As a pytest plugin it appends one line per test start and finish,
``<epoch s> <worker> start|finish <nodeid>``, to the file named by
``PYTEST_TIMELINE`` (xdist workers only; the controller writes nothing):

    PYTEST_TIMELINE=/tmp/t1.timeline python -m pytest tests/ -n 6 \\
        --dist loadfile -p tools.pytest_timeline ...

Run as a script on such a file, it prints one line per test file, in the
order the files started: start and end (seconds after the first start),
wall seconds, worker, tests finished.  Under ``--dist loadfile`` the
suite ends when its longest file ends, so the start of that file is what
a change to the other files' layout moves.

    python tools/pytest_timeline.py /tmp/t1.timeline
"""

from __future__ import annotations

import os
import sys
import time


def _log(kind: str, nodeid: str) -> None:
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    path = os.environ.get("PYTEST_TIMELINE")
    if worker is None or not path:
        return
    with open(path, "a") as f:
        f.write(f"{time.time():.3f} {worker} {kind} {nodeid}\n")


def pytest_runtest_logstart(nodeid, location):
    _log("start", nodeid)


def pytest_runtest_logfinish(nodeid, location):
    _log("finish", nodeid)


def summarize(path: str) -> list[tuple]:
    """(start, end, wall, worker, tests finished, file) per test file."""
    rows = [ln.split(None, 3) for ln in open(path) if ln.strip()]
    t0 = min(float(r[0]) for r in rows)
    files: dict[str, list] = {}
    for ts, worker, kind, nodeid in rows:
        f = files.setdefault(nodeid.strip().split("::")[0],
                             [float("inf"), 0.0, worker, 0])
        t = float(ts) - t0
        if kind == "start":
            f[0] = min(f[0], t)
        else:
            f[1] = max(f[1], t)
            f[3] += 1
    return sorted((s, e, e - s, w, n, name)
                  for name, (s, e, w, n) in files.items())


def main() -> int:
    for s, e, wall, w, n, name in summarize(sys.argv[1]):
        print(f"{s:8.1f} {e:8.1f} {wall:8.1f} {w} {n:3d} {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
