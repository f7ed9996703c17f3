"""LearnerThread — decouple gradient steps from sample collection
(reference: rllib/execution/learner_thread.py:16): rollout actors keep
producing while a background thread drains a bounded queue into
learn_on_batch. With the learner on the card this is what keeps it busy:
host-side env stepping and device-side SGD overlap instead of
alternating."""

from __future__ import annotations

import queue
import threading
import time


class LearnerThread(threading.Thread):
    def __init__(self, local_worker, max_queue: int = 16):
        super().__init__(daemon=True, name="rllib-learner")
        self.local_worker = local_worker
        self.inqueue: queue.Queue = queue.Queue(maxsize=max_queue)
        self.outqueue: queue.Queue = queue.Queue()
        self.stopped = False
        self.error: BaseException | None = None
        self.learner_info: dict = {}
        self.num_steps_trained = 0
        self.num_batches_trained = 0
        self.queue_wait_s = 0.0
        self.grad_time_s = 0.0

    def run(self):
        while not self.stopped:
            t0 = time.perf_counter()
            try:
                batch = self.inqueue.get(timeout=0.5)
            except queue.Empty:
                continue
            t1 = time.perf_counter()
            try:
                info = self.local_worker.learn_on_batch(batch)
            except BaseException as e:  # the trainer raises it (check())
                self.error = e
                self.stopped = True
                return
            t2 = time.perf_counter()
            self.queue_wait_s += t1 - t0
            self.grad_time_s += t2 - t1
            self.learner_info = info
            self.num_steps_trained += batch.count
            self.num_batches_trained += 1
            self.outqueue.put((batch.count, info))

    def stop(self):
        self.stopped = True

    def check(self):
        """Raises the error that ended the thread, if one did."""
        if self.error is not None:
            raise RuntimeError("the learner thread failed") from self.error

    def stats(self) -> dict:
        return {
            "learner_queue_size": self.inqueue.qsize(),
            "num_steps_trained": self.num_steps_trained,
            "num_batches_trained": self.num_batches_trained,
            "learner_grad_time_s": round(self.grad_time_s, 3),
            "learner_queue_wait_s": round(self.queue_wait_s, 3),
            **{f"learner/{k}": v for k, v in self.learner_info.items()},
        }
