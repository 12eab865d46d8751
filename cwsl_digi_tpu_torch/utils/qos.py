"""Thread QoS: the reference's priority ladder, POSIX-style.

The reference raises its ingest thread to ABOVE_NORMAL
(source/Receiver.hpp:168) and drops output/report/log threads to
LOWEST/IDLE (source/OutputHandler.cpp:61, PSKReporter.cpp:142,
WSPRNet.cpp:54, RBNHandler.hpp:131, CWSL_DIGI.cpp:1191) so a loaded
decode pool can never starve IQ intake or let reporting steal cycles
from it.

On Linux the per-thread analogue is ``setpriority(PRIO_PROCESS, tid, n)``
— thread ids are valid "process" ids for scheduling purposes.  Raising
priority (negative nice) needs CAP_SYS_NICE; when unavailable the ingest
thread simply stays at 0 while the best-effort threads are lowered, which
preserves the ladder's *relative* order — the property the reference
actually relies on.
"""

from __future__ import annotations

import os
import threading

# the reference's ladder, expressed as nice values
INGEST = -5        # ABOVE_NORMAL (Receiver.hpp:168)
NORMAL = 0         # decode workers
BEST_EFFORT = 10   # reporters / output parsing (OutputHandler.cpp:61)
IDLE = 19          # logging / stats printing (CWSL_DIGI.cpp:1191)


def set_current_thread_nice(nice: int) -> bool:
    """Set the calling thread's nice level; True when it took effect."""
    try:
        tid = threading.get_native_id()
        os.setpriority(os.PRIO_PROCESS, tid, nice)
        return True
    except (OSError, AttributeError):
        # raising priority without CAP_SYS_NICE: fall back to 0 so the
        # lowered best-effort threads still sit below us
        if nice < 0:
            try:
                os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 0)
            except (OSError, AttributeError):
                pass
        return False
