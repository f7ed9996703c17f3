"""In-process memory store: futures + small-object values.

The analog of the reference's CoreWorkerMemoryStore (reference:
src/ray/core_worker/store_provider/memory_store/memory_store.h:26): every
ObjectRef known to this process resolves here first. An entry is either
PENDING (a future — the producing task hasn't replied yet), a concrete
value, an error, or IN_PLASMA (sentinel meaning: fetch the bytes from the
shared-memory store).
"""

from __future__ import annotations

import threading
from typing import Any

from ray_tpu_torch._private.ids import ObjectID

IN_PLASMA = object()  # sentinel value


class _Entry:
    __slots__ = ("value", "is_exception", "ready", "callbacks")

    def __init__(self):
        self.value = None
        self.is_exception = False
        self.ready = False
        self.callbacks = None  # list[callable] | None, fired on ready


class MemoryStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._entries: dict[ObjectID, _Entry] = {}

    def open(self, object_id: ObjectID) -> None:
        """Ensure a pending entry exists (called at submit time)."""
        with self._lock:
            self._entries.setdefault(object_id, _Entry())

    def open_many(self, object_ids) -> None:
        """open() for a task's whole return set under one lock hop."""
        with self._lock:
            for object_id in object_ids:
                self._entries.setdefault(object_id, _Entry())

    def put(self, object_id: ObjectID, value: Any, is_exception=False) -> None:
        self.put_many([(object_id, value, is_exception)])

    def put_many(self, items) -> None:
        """put() for a batch of (object_id, value, is_exception) triples:
        one lock acquisition and one notify_all for a whole task reply
        (a serve batch reply is num_returns puts in a tight loop — the
        per-put lock/notify churn was measurable on the HTTP path)."""
        fired = []
        with self._cv:
            for object_id, value, is_exception in items:
                entry = self._entries.setdefault(object_id, _Entry())
                if entry.ready:
                    continue  # first write wins
                entry.value = value
                entry.is_exception = is_exception
                entry.ready = True
                if entry.callbacks:
                    fired.extend(entry.callbacks)
                entry.callbacks = None
            self._cv.notify_all()
        self._fire(fired)

    @staticmethod
    def _fire(callbacks) -> None:
        for cb in callbacks:  # outside the lock: callbacks may re-enter
            try:
                cb()
            except Exception:
                # a broken waiter (cancelled future, dead loop) must not
                # starve sibling callbacks or abort the putter's loop
                # over a task's remaining returns
                import logging

                logging.getLogger("ray_tpu_torch").exception(
                    "memstore ready-callback failed")

    def add_ready_callback(self, object_id: ObjectID, cb,
                           create: bool = True) -> bool:
        """Invoke cb() once the entry becomes ready — immediately if it
        already is. The async-get primitive: no thread parks per waiter
        (reference analog: memory_store.h GetAsync). A `delete` of a
        pending entry ALSO fires its callbacks (the waiter re-checks
        `get_if_ready`, sees not-found, and maps that to object loss), so
        an owner dropping an object can never strand a callback waiter.

        With create=False, a missing entry is NOT re-created (the caller
        races entry deletion and must not resurrect a released object);
        returns False and does not register in that case."""
        with self._lock:
            if create:
                entry = self._entries.setdefault(object_id, _Entry())
            else:
                entry = self._entries.get(object_id)
                if entry is None:
                    return False
            if not entry.ready:
                if entry.callbacks is None:
                    entry.callbacks = []
                entry.callbacks.append(cb)
                return True
        cb()
        return True

    def remove_ready_callback(self, object_id: ObjectID, cb) -> None:
        """Forget a pending ready-callback (waiter gave up — timeout or
        disconnected client); no-op if it already fired or never existed."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is not None and entry.callbacks:
                try:
                    entry.callbacks.remove(cb)
                except ValueError:
                    pass

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            entry = self._entries.get(object_id)
            return entry is not None and entry.ready

    def get_if_ready(self, object_id: ObjectID):
        """Returns (found, value, is_exception)."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.ready:
                return False, None, False
            return True, entry.value, entry.is_exception

    def wait(self, object_ids, num_returns: int, timeout: float | None):
        """Block until num_returns of object_ids are ready. Returns ready set."""
        deadline = None
        if timeout is not None:
            deadline = threading.TIMEOUT_MAX if timeout < 0 else timeout

        def ready_set():
            return {
                oid
                for oid in object_ids
                if (e := self._entries.get(oid)) is not None and e.ready
            }

        import time

        end = time.monotonic() + deadline if deadline is not None else None
        with self._cv:
            while True:
                ready = ready_set()
                if len(ready) >= num_returns:
                    return ready
                remaining = None
                if end is not None:
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        return ready
                self._cv.wait(remaining)

    def reset(self, object_id: ObjectID) -> None:
        """Return an entry to PENDING (object reconstruction: the lost
        value is being recomputed, so `put` must win again)."""
        with self._lock:
            old = self._entries.get(object_id)
            fresh = _Entry()
            if old is not None and not old.ready:
                fresh.callbacks = old.callbacks  # waiters follow the redo
            self._entries[object_id] = fresh

    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            entry = self._entries.pop(object_id, None)
            fired = entry.callbacks if entry is not None else None
            if entry is not None:
                entry.callbacks = None
        if fired:
            self._fire(fired)

    def size(self) -> int:
        with self._lock:
            return len(self._entries)
