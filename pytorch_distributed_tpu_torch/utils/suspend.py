"""Cooperative preemption: the suspend, checkpoint, yield protocol
(``pytorch_distributed_tpu/utils/suspend.py``).

The reference polls ``hfai.client.receive_suspend_command()`` every step
and yields with ``go_suspend()`` after saving (``restnet_ddp.py:36-47``).
The signal sources here are the ones a cluster job gets:

- SIGTERM / SIGUSR1 (an eviction or preemption with a grace window);
- a flag file (``SUSPEND_FLAG_FILE`` or the constructor's ``flag_file``),
  polled at most every ``poll_interval`` seconds;
- ``request_suspend()`` in-process (tests, the ``suspend`` fault, the
  watchdog).
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import threading
import time
from typing import Optional

logger = logging.getLogger("pytorch_distributed_tpu_torch")


class SuspendWatcher:
    """``receive_suspend_command()`` is cheap enough for every step and
    sticky once set; ``go_suspend`` exits after the caller checkpointed."""

    def __init__(self, flag_file: Optional[str] = None,
                 signals=(signal.SIGTERM, signal.SIGUSR1), poll_interval: float = 1.0,
                 install_handlers: bool = True):
        self.flag_file = flag_file or os.environ.get("SUSPEND_FLAG_FILE")
        self.poll_interval = poll_interval
        self._event = threading.Event()
        self._last_poll = 0.0
        # chain to the handler installed before ours; uninstall restores it
        self._prev_handlers: dict = {}
        if install_handlers:
            for sig in signals:
                try:
                    prev = signal.signal(sig, self._on_signal)
                except (ValueError, OSError):  # not the main thread
                    logger.debug("could not install handler for %s", sig)
                else:
                    self._prev_handlers[sig] = prev

    def _on_signal(self, signum, frame) -> None:
        logger.warning("received signal %d: suspend requested", signum)
        self._event.set()
        prev = self._prev_handlers.get(signum)
        if callable(prev):  # SIG_DFL / SIG_IGN / None are not callable
            prev(signum, frame)

    def uninstall(self) -> None:
        """Restore the handlers this watcher displaced, where ours is still
        the one installed."""
        for sig, prev in list(self._prev_handlers.items()):
            try:
                if signal.getsignal(sig) == self._on_signal:
                    signal.signal(sig, prev)
            except (ValueError, OSError):
                logger.debug("could not restore handler for %s", sig)
            del self._prev_handlers[sig]

    def request_suspend(self) -> None:
        self._event.set()

    def receive_suspend_command(self) -> bool:
        """True once a suspend was requested: a signal at once, the flag
        file at the next poll."""
        if self._event.is_set():
            return True
        if self.flag_file:
            now = time.monotonic()
            if now - self._last_poll >= self.poll_interval:
                self._last_poll = now
                if os.path.exists(self.flag_file):
                    logger.warning("suspend flag file %s present", self.flag_file)
                    self._event.set()
        return self._event.is_set()

    def go_suspend(self, exit_code: int = 0) -> None:
        """Yield to the scheduler: ``sys.exit(exit_code)``. The relaunch
        resumes from the checkpoint (``restnet_ddp.py:47,127-132``)."""
        logger.warning("suspending: yielding to scheduler (exit %d)", exit_code)
        sys.exit(exit_code)


class NullSuspendWatcher(SuspendWatcher):
    """Never fires: no handlers, no flag file."""

    def __init__(self):
        super().__init__(flag_file=None, install_handlers=False)

    def receive_suspend_command(self) -> bool:
        return False
