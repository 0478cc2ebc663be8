"""Per-step deadline watchdog (``pytorch_distributed_tpu/resilience/watchdog.py``
``dump_all_stacks``:39, ``Watchdog``:51).

The trainer calls ``beat()`` after every step; a daemon thread checks the
deadline. A stall of ``timeout_s`` dumps every thread's stack to the log
and to ``dump_path`` (the trainers pass ``<save_dir>/watchdog_stall.log``
on rank 0) and latches the ``SuspendWatcher``, so a loop that recovers
checkpoints and yields at its next step. One stall, one dump; the next
beat re-arms it. Not ported: the hard-hang exit (``exit_code``,
``grace_s``), which no trainer sets, and the fleet's many-heartbeat
watchdog, which comes with the serving fleet.
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
