"""Host clocks: ``now`` for the window, ``since_start`` for set-up (from
the process's own start, so imports and interpreter start-up count)."""
from __future__ import annotations

import os
import time

now = time.perf_counter
_IMPORTED = time.perf_counter()


def since_start() -> float:
    """Seconds since this process started: from /proc where it can be
    read (10 ms ticks), else since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED
