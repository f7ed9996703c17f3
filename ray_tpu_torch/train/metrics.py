"""Training-plane metrics; copy of ray_tpu/train/metrics.py:16-34.

step_s is the whole step: the input wait (the ingest get, the loader's
next) and the dispatch; ingest_wait_s isolates the input half, so
"input-bound" reads off the pair (a healthy double-buffered ingest keeps
ingest_wait_s p50 near 0 while step_s tracks compute). optim_shard_bytes
is the process's optimizer-state footprint: 1/N of the replicated figure
once the weight update is sharded."""

from __future__ import annotations

from ray_tpu_torch._private import stats

STEP_S = stats.Histogram(
    "train.step_s", stats.LATENCY_BOUNDARIES_S,
    "one training step wall time, input wait included (per worker)")

TOKENS_TOTAL = stats.Count(
    "train.tokens_total",
    "training examples consumed by dispatched steps (per worker; "
    "tokens/s = delta over the metrics history)")

INGEST_WAIT_S = stats.Histogram(
    "train.ingest_wait_s", stats.LATENCY_BOUNDARIES_S,
    "time the step loop blocked waiting for the next prefetched ingest "
    "batch (p50 ~0 = input fully overlapped with compute)")

OPT_SHARD_BYTES = stats.Gauge(
    "train.optim_shard_bytes",
    "bytes of optimizer state held by this worker (the local 1/N shard "
    "under the sharded weight update; the full replicated state "
    "otherwise)")
