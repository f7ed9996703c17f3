"""Serve production-tier counters (admission control, replica groups,
zero-copy payload plane); port of ray_tpu/serve/metrics.py, the same
names. Registered in whichever process hosts the component
(proxy/driver routers, the controller actor's worker, replica workers)
and read from that process's stats snapshot."""

from __future__ import annotations

from ray_tpu_torch._private import stats as _stats

M_SHED_TOTAL = _stats.Count(
    "serve.shed_total",
    "requests refused at router admission (queue depth >= "
    "max_queued_requests) with a typed ServeOverloadedError / HTTP 503")

M_ADMITTED_TOTAL = _stats.Count(
    "serve.admitted_total",
    "requests accepted into a bounded router queue (pairs with "
    "serve.shed_total: shed rate = shed / (shed + admitted))")

M_ROUTER_QUEUED = _stats.Gauge(
    "serve.router_queued",
    "live queued queries across this process's routers (the admission "
    "gauge shed/cancel paths must keep honest)")

M_GROUP_RESTARTS_TOTAL = _stats.Count(
    "serve.group_restarts_total",
    "sharded replica-group gang restarts (any member death restarts the "
    "whole gang)")

M_ZERO_COPY_BYTES_TOTAL = _stats.Count(
    "serve.zero_copy_bytes_total",
    "request/response body bytes that rode the object store as "
    "ObjectRefs instead of being pickled through the router")

# -- streaming inference tier (continuous batching / paged KV-cache) -----

M_TOKENS_TOTAL = _stats.Count(
    "serve.tokens_total",
    "tokens emitted by decode engines in this process (the streaming "
    "tier's goodput counter; tokens/s = delta over the metrics history)")

M_TTFT_S = _stats.Histogram(
    "serve.ttft_s", _stats.LATENCY_BOUNDARIES_S,
    "sequence admission -> first emitted token (engine side): the "
    "latency continuous batching decouples from total generation time")

M_DECODE_BATCH = _stats.Gauge(
    "serve.decode_batch_size",
    "running sequences in this process's decode engine batch (occupancy "
    "of the token-level scheduler; waiting sequences are not counted)")

M_DECODE_STEP_S = _stats.Histogram(
    "serve.decode_step_s", _stats.LATENCY_BOUNDARIES_S,
    "one decode step: batch assembly + (gang fan-out +) forward + "
    "allreduce + token append/emit (the decode stage)")

M_KV_PAGES = _stats.Gauge(
    "serve.kv_pages_in_use",
    "allocated KV-cache pages across this process's page pools (moves "
    "with every alloc/free; sequence finish/abort must return it)")

M_SESSIONS_EVICTED_TOTAL = _stats.Count(
    "serve.sessions_evicted_total",
    "session KV-cache entries evicted (LRU past session_cache_max): the "
    "evicted session's next turn opens COLD — stream_open reports "
    "session_cached=false and the client must resend full history")

# -- KV-cache economy (cross-session prefix sharing) ----------------------

M_PREFIX_HITS = _stats.Count(
    "serve.prefix_hits_total",
    "admissions that adopted a nonempty page-aligned prefix from the "
    "per-replica PrefixIndex (the shared prefill was NOT recomputed)")

M_PREFIX_SAVED = _stats.Count(
    "serve.prefix_prefill_tokens_saved_total",
    "prompt tokens whose prefill was skipped by prefix adoption (an "
    "N-session shared prefix pays prefill once: this grows by "
    "(N-1) x page-aligned prefix length)")

M_KV_PAGES_SHARED = _stats.Gauge(
    "serve.kv_pages_shared",
    "KV pages with refcount > 1 (held by several sequences/sessions "
    "and/or the prefix index at once): the HBM the economy is saving")

M_ROUTER_SESSIONS_PRUNED = _stats.Count(
    "serve.router_sessions_pruned_total",
    "router sticky-session entries dropped: LRU past the bounded table "
    "cap, or pruned by engine eviction feedback in the stream meta (a "
    "pruned session re-routes by prefix index / least-loaded)")

M_KV_WARM_PAGES = _stats.Count(
    "serve.kv_warm_pages_total",
    "prefix pages a fresh replica imported from a sibling over the bulk "
    "channel at scale-up (prefill compute NOT recomputed on the new "
    "replica)")
