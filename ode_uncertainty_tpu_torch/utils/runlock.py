"""Run coordination between a benchmark and long jobs on one device (port of
``ode_uncertainty_tpu/utils/runlock.py``; plain Python, copied).

Protocol (plain files, no daemons):

  * ``BENCH_LOCK`` (``odeuq_bench.lock`` in the temporary directory,
    ``TMPDIR``; ``ODEUQ_BENCH_LOCK`` overrides): written by a benchmark
    (content: its pid) while it runs. A lock whose pid is dead is stale and
    removed.
  * Long-running clients call :func:`register_client` at startup (pid file
    ``odeuq_client.pid`` beside it; ``ODEUQ_CLIENT_PID`` overrides) and
    :func:`check_quiesce` at every checkpointed iteration boundary; while the
    bench lock is active they raise :class:`QuiesceRequested` (a
    ``SystemExit`` with code 75, EX_TEMPFAIL) after their state has been
    saved, so yielding loses at most one optimizer iteration.
  * A supervising script treats exit code 75 as "wait for ``BENCH_LOCK`` to
    go, then relaunch", not as a failure.
"""

from __future__ import annotations

import os
import tempfile

BENCH_LOCK = os.environ.get("ODEUQ_BENCH_LOCK", os.path.join(tempfile.gettempdir(), "odeuq_bench.lock"))
CLIENT_PID_FILE = os.environ.get("ODEUQ_CLIENT_PID", os.path.join(tempfile.gettempdir(), "odeuq_client.pid"))

#: Exit code for "yielded to the benchmark; relaunch me later" (EX_TEMPFAIL).
QUIESCE_EXIT_CODE = 75


class QuiesceRequested(SystemExit):
    """Raised by a long-running client yielding the device to the benchmark."""

    def __init__(self, message: str = "bench lock active; yielding the device"):
        super().__init__(QUIESCE_EXIT_CODE)
        self.message = message


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _read_pid(path: str) -> int | None:
    try:
        with open(path) as f:
            return int(f.read().strip() or 0) or None
    except (OSError, ValueError):
        return None


def bench_lock_active() -> bool:
    """True iff the bench lock exists and its owning pid is alive.

    A stale lock (owner dead, e.g. a killed bench) is removed so it can
    never permanently wedge the queues.
    """
    if not os.path.exists(BENCH_LOCK):
        return False
    pid = _read_pid(BENCH_LOCK)
    if pid is not None and _pid_alive(pid):
        return True
    try:
        os.remove(BENCH_LOCK)
    except OSError:
        pass
    return False


def acquire_bench_lock() -> None:
    """Writes the bench lock for the calling process (idempotent)."""
    with open(BENCH_LOCK, "w") as f:
        f.write(str(os.getpid()))


def release_bench_lock() -> None:
    pid = _read_pid(BENCH_LOCK)
    if pid in (None, os.getpid()):
        try:
            os.remove(BENCH_LOCK)
        except OSError:
            pass


def register_client() -> None:
    """Records this process as the active device client (pid file)."""
    try:
        with open(CLIENT_PID_FILE, "w") as f:
            f.write(str(os.getpid()))
    except OSError:
        pass


def active_client_pid() -> int | None:
    """Pid of the registered device client if it is alive, else None."""
    pid = _read_pid(CLIENT_PID_FILE)
    if pid is not None and pid != os.getpid() and _pid_alive(pid):
        return pid
    return None


def check_quiesce(where: str = "") -> None:
    """Raises :class:`QuiesceRequested` if the benchmark wants the device.

    Call ONLY at a point where all resumable state has been persisted.
    """
    if bench_lock_active():
        print(f"[runlock] bench lock active; yielding the device ({where})", flush=True)
        raise QuiesceRequested()
