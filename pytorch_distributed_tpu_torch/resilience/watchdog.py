"""Deadline watchdogs (``pytorch_distributed_tpu/resilience/watchdog.py``
``dump_all_stacks``:39, ``Watchdog``:51, ``FleetWatchdog``:213).

The trainer calls ``beat()`` after every step; a daemon thread checks the
deadline. A stall of ``timeout_s`` dumps every thread's stack to the log
and to ``dump_path`` (the trainers pass ``<save_dir>/watchdog_stall.log``
on rank 0) and latches the ``SuspendWatcher``, so a loop that recovers
checkpoints and yields at its next step. One stall, one dump; the next
beat re-arms it. Not ported: the hard-hang exit (``exit_code``,
``grace_s``), which no trainer sets.

``FleetWatchdog`` is the serving fleet's: one named heartbeat a replica,
one watcher. The fleet router beats a replica's heartbeat around each of
its ticks and condemns a tick that overran its deadline by its own clock;
the watcher (``start()``, or ``check()`` called directly) names a
heartbeat gone quiet while its tick is still running.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
import traceback
from typing import Callable, Optional

logger = logging.getLogger("pytorch_distributed_tpu_torch")


def dump_all_stacks() -> str:
    """Every live thread's current stack."""
    names = {t.ident: t.name for t in threading.enumerate()}
    return "\n".join(
        f"--- thread {names.get(ident, '?')} ({ident}) ---\n"
        + "".join(traceback.format_stack(frame))
        for ident, frame in sys._current_frames().items())


class Watchdog:
    def __init__(self, timeout_s: float, *, watcher=None, dump_path: Optional[str] = None,
                 on_stall: Optional[Callable[[str], None]] = None,
                 poll_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.watcher = watcher
        self.dump_path = dump_path
        self.on_stall = on_stall
        self.poll_s = float(poll_s) if poll_s else min(1.0, self.timeout_s / 4.0)
        self.stalls = 0
        self._last = time.monotonic()
        self._armed = False  # armed by the first beat
        self._fired = False  # one dump a stall
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="pdt-watchdog",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def beat(self) -> None:
        """A step completed: re-arm the deadline."""
        self._last = time.monotonic()
        self._armed = True
        self._fired = False

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            if not self._armed or self._fired:
                continue
            stalled = time.monotonic() - self._last
            if stalled >= self.timeout_s:
                self._fired = True
                self.stalls += 1
                self._handle_stall(stalled)

    def _handle_stall(self, stalled_s: float) -> None:
        dump = dump_all_stacks()
        logger.error("watchdog: no step heartbeat for %.1fs (deadline %.1fs); all-thread "
                     "stacks:\n%s", stalled_s, self.timeout_s, dump)
        if self.dump_path:
            try:
                with open(self.dump_path, "a") as f:
                    f.write(f"=== watchdog stall #{self.stalls} ({stalled_s:.1f}s) ===\n"
                            f"{dump}\n")
            except OSError as e:
                logger.error("watchdog: could not write dump: %s", e)
        if self.watcher is not None:
            self.watcher.request_suspend()
        if self.on_stall is not None:
            try:
                self.on_stall(dump)
            except Exception:
                logger.exception("watchdog: on_stall callback failed")


class FleetWatchdog:
    """Many named heartbeats, one watcher thread.

    ``watch(name)`` registers a heartbeat armed now, ``beat(name)``
    re-arms it and ``unwatch(name)`` retires it (a dead replica). A
    heartbeat quiet for ``timeout_s`` fires ``on_stall(name, stalled_s,
    dump)`` once, with every thread's stack, until its next beat.
    ``check()`` evaluates every heartbeat now and returns the names that
    fired: the thread calls it each poll, and tests call it directly."""

    def __init__(self, timeout_s: float, *,
                 on_stall: Optional[Callable[[str, float, str], None]] = None,
                 dump_path: Optional[str] = None, poll_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.on_stall = on_stall
        self.dump_path = dump_path
        self.poll_s = float(poll_s) if poll_s else min(1.0, self.timeout_s / 4.0)
        self.stalls = 0
        self._lock = threading.Lock()
        self._beats: dict = {}  # name -> (last beat, fired)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FleetWatchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="pdt-fleet-watchdog",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "FleetWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def watch(self, name: str) -> None:
        """Register (or re-register) heartbeat ``name``, armed now."""
        with self._lock:
            self._beats[name] = (time.monotonic(), False)

    def unwatch(self, name: str) -> None:
        with self._lock:
            self._beats.pop(name, None)

    def beat(self, name: str) -> None:
        with self._lock:
            self._beats[name] = (time.monotonic(), False)

    def stalled(self) -> list:
        """Names past their deadline now, fired or not."""
        now = time.monotonic()
        with self._lock:
            return sorted(n for n, (last, _) in self._beats.items()
                          if now - last >= self.timeout_s)

    def check(self) -> list:
        """Fire ``on_stall`` for every heartbeat newly past its deadline;
        returns their names."""
        now = time.monotonic()
        fired = []
        with self._lock:
            for name, (last, already) in list(self._beats.items()):
                if now - last >= self.timeout_s and not already:
                    self._beats[name] = (last, True)
                    fired.append((name, now - last))
        for name, stalled_s in fired:
            self.stalls += 1
            self._handle_stall(name, stalled_s)
        return [name for name, _ in fired]

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check()

    def _handle_stall(self, name: str, stalled_s: float) -> None:
        dump = dump_all_stacks()
        logger.error("fleet watchdog: no %s heartbeat for %.1fs (deadline %.1fs); all-thread "
                     "stacks:\n%s", name, stalled_s, self.timeout_s, dump)
        if self.dump_path:
            try:
                with open(self.dump_path, "a") as f:
                    f.write(f"=== fleet watchdog stall #{self.stalls} [{name}] "
                            f"({stalled_s:.1f}s) ===\n{dump}\n")
            except OSError as e:
                logger.error("fleet watchdog: could not write dump: %s", e)
        if self.on_stall is not None:
            try:
                self.on_stall(name, stalled_s, dump)
            except Exception:
                logger.exception("fleet watchdog: on_stall callback failed")
