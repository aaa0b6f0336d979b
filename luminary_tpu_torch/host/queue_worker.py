"""Work queues and worker threads.

Mirrors the reference's host threading architecture (reference:
src/luminary/queue.c — MPMC blocking queue with push_unique dedup;
queue_worker.c:17-67 — generic drain loop with deferred re-enqueue;
thread_status.c — per-worker "what am I doing and for how long"
introspection surfaced through the public API, host.h:46-70).

A host copy of ``luminary_tpu/host/queue_worker.py``: the port keeps its own
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class QueueEntry:
    """reference: host/host.c QueueEntry{name, function, ...}."""

    name: str
    function: Callable[[], None]
    dedup_key: str | None = None  # reference: remove_duplicates + eq op
    deferring_func: Callable[[], bool] | None = None  # True = not ready yet


class WorkQueue:
    """Blocking MPMC queue with optional per-key deduplication."""

    def __init__(self, name: str):
        self.name = name
        self._q: queue.Queue[QueueEntry | None] = queue.Queue()
        self._pending_keys: set[str] = set()
        self._lock = threading.Lock()

    def push(self, entry: QueueEntry) -> bool:
        """Enqueue; dedup'd entries return False when already pending
        (reference: queue_push_unique)."""
        if entry.dedup_key is not None:
            with self._lock:
                if entry.dedup_key in self._pending_keys:
                    return False
                self._pending_keys.add(entry.dedup_key)
        self._q.put(entry)
        return True

    def pop(self, timeout: float | None = None) -> QueueEntry | None:
        try:
            entry = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        if entry is not None and entry.dedup_key is not None:
            with self._lock:
                self._pending_keys.discard(entry.dedup_key)
        return entry

    def stop(self):
        self._q.put(None)

    def __len__(self) -> int:
        return self._q.qsize()


class QueueWorker:
    """A thread draining a WorkQueue, with wall-time introspection
    (reference: queue_worker.c + thread_status.c)."""

    def __init__(self, name: str, work_queue: WorkQueue):
        self.name = name
        self.queue = work_queue
        self._current: str | None = None
        self._started_at: float = 0.0
        self._errors: list[BaseException] = []
        self._online = False
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)

    def start(self):
        self._online = True
        self._thread.start()

    def _run(self):
        while True:
            entry = self.queue.pop()
            if entry is None:
                break
            if entry.deferring_func is not None and entry.deferring_func():
                # Not ready: re-enqueue and yield (reference:
                # queue_worker.c:35-42 deferred work items).
                self.queue.push(entry)
                time.sleep(0.001)
                continue
            self._current = entry.name
            self._started_at = time.monotonic()
            try:
                entry.function()
            except BaseException as e:  # surfaced via Host.check_errors
                self._errors.append(e)
            finally:
                self._current = None
        self._online = False

    # -- introspection (reference: luminary_host_get_queue_worker_*) --------

    @property
    def online(self) -> bool:
        return self._online

    @property
    def current_task(self) -> str | None:
        return self._current

    @property
    def current_task_time(self) -> float:
        return time.monotonic() - self._started_at if self._current else 0.0

    def take_errors(self) -> list[BaseException]:
        errs, self._errors = self._errors, []
        return errs

    def shutdown(self, join: bool = True):
        self.queue.stop()
        if join and self._thread.is_alive():
            self._thread.join(timeout=30.0)
