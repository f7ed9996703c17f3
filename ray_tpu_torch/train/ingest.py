"""Streaming ingest: sharded dataset actors produce each rank's batches
into the object store, and each train worker prefetches `prefetch_depth`
batches ahead (double-buffered at the default depth 2), so that input
time overlaps the step instead of coming before it; port of
ray_tpu/train/ingest.py.

Data path: `DatasetShard.next_batch` returns the batch through the normal
actor return path, so a large batch lands in the shared-memory store as
host bytes; the worker's operator moves it to its card (`_to_device`).
The worker's `IngestStream` keeps at most `prefetch_depth` requests in
flight and observes `train.ingest_wait_s` around each blocking get: the
"is training input-bound?" histogram.

Failure domain: an ingest actor dying mid-epoch surfaces as a typed actor
error inside the consuming worker's epoch; the Trainer's gang scan treats
a dead ingest actor as a dead worker (the re-gang restarts the workers
AND their dataset actors at the surviving world size, which re-shards the
dataset). Un-consumed prefetched refs are dropped on every exit path.

Not ported: the `train.ingest_batch` failpoint and
`DatasetShard.failpoints()`, which wait for the port's failpoints
(ROADMAP.md queue A item 4.6)."""

from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import time
from typing import Any, Callable

# End-of-epoch sentinel: the actor returns (not raises) it, so prefetched
# requests past the end resolve cheaply instead of erroring.
_END = "__ray_tpu_ingest_end__"


@dataclasses.dataclass
class IngestSpec:
    """Trainer(ingest=IngestSpec(...)): one DatasetShard actor per worker
    rank.

    dataset_fn(shard_index, num_shards, config) -> either a reusable
    sequence of batches (replayed every epoch) or a callable
    ``epoch -> iterable`` for epoch-varying streams. Cloudpickled to the
    actor, so closures and __main__ classes work.

    prefetch_depth: in-flight batches per worker (None = the
    `train_ingest_prefetch_depth` setting, 2: double buffering).
    resources: per-dataset-actor resource dict (default {"CPU": 1})."""

    dataset_fn: Callable[[int, int, dict], Any]
    prefetch_depth: int | None = None
    resources: dict | None = None


class DatasetShard:
    """Actor producing one rank's batch stream. Single-threaded actor
    semantics deliver `next_batch` in order, so the worker's pipelined
    requests arrive as a strictly sequential pull."""

    def __init__(self, dataset_fn_pickled: bytes, shard_index: int,
                 num_shards: int, config: dict | None):
        fn = pickle.loads(dataset_fn_pickled)
        self._source = fn(shard_index, num_shards, config or {})
        self._gen = None
        self._iter = None

    def next_batch(self, gen: int, epoch: int):
        """Next batch of the consumer's iteration `gen`, or the end
        sentinel. A new gen rebuilds the iterator: gen (not epoch) is the
        rebuild key, so an epoch RETRIED after a mid-stream abort replays
        from the start instead of resuming a half-consumed iterator.
        Sequences replay as they are; callables get the epoch."""
        if gen != self._gen:
            src = (self._source(epoch) if callable(self._source)
                   else self._source)
            self._iter = iter(src)
            self._gen = gen
        try:
            return next(self._iter)
        except StopIteration:
            return _END

    def ping(self) -> int:
        """The actor's pid, once it is up (the Trainer waits on it when it
        kills a generation)."""
        return os.getpid()


class IngestStream:
    """Worker-side iterable over one DatasetShard, `depth` requests in
    flight. A fresh iterator each epoch (the operator's epoch counter is
    read lazily, so one IngestStream serves the whole run)."""

    def __init__(self, actor, depth: int, epoch_fn: Callable[[], int],
                 get_timeout: float = 300.0):
        self._actor = actor
        self._depth = max(1, int(depth))
        self._epoch_fn = epoch_fn
        self._timeout = get_timeout
        self._gen = 0

    def __iter__(self):
        import ray_tpu_torch
        from ray_tpu_torch.train import metrics as _tm

        epoch = self._epoch_fn()
        self._gen += 1
        gen = self._gen
        refs: collections.deque = collections.deque()
        try:
            while True:
                while len(refs) < self._depth:
                    refs.append(self._actor.next_batch.remote(gen, epoch))
                t0 = time.perf_counter()
                batch = ray_tpu_torch.get(refs.popleft(),
                                          timeout=self._timeout)
                _tm.INGEST_WAIT_S.observe(time.perf_counter() - t0)
                if isinstance(batch, str) and batch == _END:
                    return
                yield batch
        finally:
            # drop in-flight refs on every exit (end, error, early break):
            # out-of-scope ObjectRefs release their store entries
            refs.clear()


def hist_quantile(snap: dict, q: float) -> float:
    """Quantile upper bound from a Histogram snapshot (the readback of
    `train.ingest_wait_s`): the boundary of the bucket where the
    cumulative count crosses q (inf for the overflow bucket)."""
    n = snap.get("count", 0)
    if not n:
        return 0.0
    target = q * n
    cum = 0
    for i, c in enumerate(snap["counts"]):
        cum += c
        if cum >= target:
            bounds = snap["boundaries"]
            return bounds[i] if i < len(bounds) else float("inf")
    return float("inf")
