"""Worker threads for the lagged fleet loop's host work
(``pytorch_distributed_tpu/serving/host_worker.py``, a copy).

The fleet router's ``async_host`` loop keeps its own thread for dispatch
and collect and hands the work that can wait to this pool: the
percentile math of each scheduler's gate-metrics snapshot
(``Scheduler.gate_metrics``). A work item touches only data copied onto
its closure when it was queued and caches guarded by their own lock;
scheduler and router state (queues, resident requests, the allocator,
block tables) belong to the serving thread alone.

Pool counters change only under ``_lock``. A worker's exception never
stops the serve mid-tick: it is kept in ``errors`` and raised at the next
``flush()``. Items start in submission order on one FIFO queue and may
finish out of order across threads; the gate snapshot keeps the newest.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional

#: sentinel a closing pool feeds each worker
_STOP = object()


class HostWorkerPool:
    """N named daemon threads draining one FIFO queue of closures.

    ``submit(fn)`` enqueues; ``flush()`` blocks until everything
    enqueued so far has run (and re-raises the first worker error);
    ``close()`` flushes and joins the threads (named ``pdt-host-0``
    ...).
    """

    def __init__(self, n_threads: int = 2, name: str = "pdt-host"):
        if n_threads < 1:
            raise ValueError(f"n_threads must be >= 1, got {n_threads}")
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self.submitted = 0
        self.completed = 0
        self.errors: List[BaseException] = []
        self._threads = [
            threading.Thread(target=self._run, name=f"{name}-{i}",
                             daemon=True)
            for i in range(n_threads)
        ]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            if fn is _STOP:
                self._q.task_done()
                return
            try:
                fn()
            except BaseException as e:  # latch; re-raised at flush()
                with self._lock:
                    self.errors.append(e)
            finally:
                with self._lock:
                    self.completed += 1
                self._q.task_done()

    def submit(self, fn: Callable[[], None]) -> None:
        """Enqueue one closure (FIFO start order). Raises after
        ``close()`` — a closed pool silently dropping work would lose
        JSONL records."""
        with self._lock:
            if self._closed:
                raise RuntimeError("HostWorkerPool is closed")
            self.submitted += 1
        self._q.put(fn)

    def flush(self) -> None:
        """Block until every submitted item has run; re-raise the first
        worker error (cleared, so a handled failure does not re-fire at
        every later barrier)."""
        self._q.join()
        with self._lock:
            errors, self.errors = self.errors, []
        if errors:
            raise RuntimeError(
                f"{len(errors)} host-worker task(s) failed"
            ) from errors[0]

    @property
    def pending(self) -> int:
        """Items submitted but not yet completed (approximate — racing
        a draining worker — but monotone-consistent enough for tests
        and the top view)."""
        with self._lock:
            return self.submitted - self.completed

    def close(self) -> None:
        """Flush, then stop and join every worker. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.join()
        for _ in self._threads:
            self._q.put(_STOP)
        for t in self._threads:
            t.join()
        with self._lock:
            errors, self.errors = self.errors, []
        if errors:
            raise RuntimeError(
                f"{len(errors)} host-worker task(s) failed"
            ) from errors[0]
