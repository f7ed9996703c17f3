"""Token-level continuous-batching decode engine; port of
ray_tpu/serve/engine.py (the Orca/vLLM iteration-level scheduler sized
for this runtime).

The Megatron gang forward becomes one *step* of a decode
loop instead of the whole request: each loop iteration the engine
(running inside the gang LEADER, or inside a plain replica for
unsharded deployments) assembles a `StepPlan` — sequences to abort,
new sequences to admit from the bounded waiting queue, and the running
batch — fans the plan to the follower ranks (one actor call per
follower per step; actor-call ordering from the single engine thread
keeps every rank's op stream aligned), and every rank applies it
identically: prefill-embed the admitted prompts into its shard of the
paged KV-cache, gather each running sequence's cache sum, compute the
shard-partial logits, allreduce(SUM) over the gang's collective group,
argmax the next token, append its KV entry, and retire sequences that
hit EOS or max_tokens. Only the leader additionally EMITS tokens into
per-sequence `TokenChannel`s — time-to-first-token is one step after
admission, decoupled from total generation length, and finished short
sequences retire (and free their pages) while long ones keep decoding.

Determinism: every rank sees the same plan, the same allreduced logits
and therefore makes the same finish/eviction/exhaustion decisions, so
follower mirrors never need a second protocol round. Client aborts —
the only non-deterministic event — always travel in the plan.

Failure domain: a member death mid-step starves the allreduce; the
leader maps the timeout to typed `ReplicaGroupDied`, finishes EVERY
open channel with it, frees all KV pages, and marks the engine dead
(the controller's gang restart brings a fresh engine). Session state
dies with the gang — affinity routing falls back to least-loaded.

Chaos seams: `serve.decode_step` (every rank, top of each applied
step), `serve.stream_emit` (leader emit), `serve.kv_page_alloc`
(page allocation).
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import OrderedDict

import numpy as np

from ray_tpu_torch._private import failpoints as _fp
from ray_tpu_torch.serve.kv_cache import (KVCacheExhausted, PagedKVCache,
                                          prefix_block_hashes)
from ray_tpu_torch.serve.metrics import (M_DECODE_BATCH, M_DECODE_STEP_S,
                                         M_KV_WARM_PAGES,
                                         M_SESSIONS_EVICTED_TOTAL,
                                         M_TOKENS_TOTAL, M_TTFT_S)
from ray_tpu_torch.serve.streaming import TokenChannel

# finished channels are kept this long for late/reconnecting readers,
# then reaped by the decode loop
CHANNEL_TTL_S = 60.0

_SESSION_PREFIX = "sess:"


# ---------------------------------------------------------------------------
# reference streaming model (the generative sibling of ShardedMLP)
# ---------------------------------------------------------------------------


class ShardedTokenLM:
    """Integer-weight autoregressive reference model whose per-token KV
    entry is a Megatron-partitioned MLP activation.

    next_logits = relu(sum_t u_t) @ W_out,  u_t = relu(E[tok_t] @ W_up)

    W_up is COLUMN-sharded and W_out ROW-sharded (parallel.sharding
    kv_slice bounds), so each rank's cached u_t slice is shard-local —
    the per-shard KV page slices of the paged cache — and one
    allreduce(SUM) per step recovers the full logits. With
    integer-valued f32 weights every partial product and running sum is
    exactly representable: the sharded continuous-batching decode is
    BIT-exact vs this class's own single-process `generate`, whatever
    the batch composition (the A/B test's pin).
    """

    def __init__(self, embed, w_up, w_out, eos_token: int = 0):
        self.embed = np.asarray(embed, dtype=np.float32)
        self.w_up = np.asarray(w_up, dtype=np.float32)
        self.w_out = np.asarray(w_out, dtype=np.float32)
        self.eos_token = int(eos_token)
        self.vocab = self.embed.shape[0]
        self._shard = None

    @classmethod
    def make(cls, seed: int, vocab: int = 32, hidden: int = 8,
             inner: int = 16, eos_token: int = 0) -> "ShardedTokenLM":
        """Deterministic integer-weight instance (tests/bench)."""
        rng = np.random.default_rng(seed)
        return cls(rng.integers(-2, 3, (vocab, hidden)),
                   rng.integers(-2, 3, (hidden, inner)),
                   rng.integers(-2, 3, (inner, vocab)),
                   eos_token=eos_token)

    def shard(self, rank: int, num_shards: int) -> "ShardedTokenLM":
        from ray_tpu_torch.parallel.sharding import kv_slice

        # one slice bound drives BOTH weights and the cache width, so
        # the KV pages this rank writes are exactly the columns its
        # up-projection produces (per-shard KV page slices)
        lo, hi = kv_slice(self.w_up.shape[-1], rank, num_shards)
        self.w_up = self.w_up[:, lo:hi]
        self.w_out = self.w_out[lo:hi]
        self._shard = (rank, num_shards)
        return self

    @property
    def kv_width(self) -> int:
        """Per-rank KV vector width (this shard's slice of the inner
        dim — the paged cache's row width)."""
        return self.w_up.shape[-1]

    def embed_tokens(self, tokens) -> np.ndarray:
        """KV entries for `tokens`: (T, kv_width) shard-local slices."""
        toks = np.asarray(tokens, dtype=np.int64) % self.vocab
        return np.maximum(self.embed[toks] @ self.w_up, 0.0)

    def partial_logits(self, sums) -> np.ndarray:
        """(B, kv_width) cache sums -> (B, vocab) PARTIAL logits the
        gang allreduces (unsharded: already the full logits)."""
        return np.maximum(np.asarray(sums, dtype=np.float32), 0.0) \
            @ self.w_out

    @staticmethod
    def next_tokens(logits) -> np.ndarray:
        """Greedy decode, ties to the lowest index — deterministic
        across batch compositions and rank counts."""
        return np.argmax(np.asarray(logits), axis=-1)

    def generate(self, prompt, max_tokens: int) -> list[int]:
        """Single-process full-generation reference (and the
        request-level serving arm via __call__): the exact loop the
        engine runs, without paging or batching."""
        u = self.embed_tokens(list(prompt))
        total = u.sum(axis=0)
        out: list[int] = []
        for _ in range(int(max_tokens)):
            logits = self.partial_logits(total[None, :])[0]
            tok = int(np.argmax(logits))
            out.append(tok)
            if tok == self.eos_token:
                break
            total = total + self.embed_tokens([tok])[0]
        return out

    def generate_batch(self, prompts: list, max_tokens: list) -> list:
        """Request-level BATCHED decoding (the preserved A/B control
        arm): the batch is one tensor stepped in LOCKSTEP until every
        row finishes — finished short rows keep burning compute as
        padding and the batch's composition is frozen at admission,
        exactly the inefficiency iteration-level scheduling removes.
        Each row's tokens are identical to generate() (rows are
        independent), so the A/B is bit-exact either way."""
        n = len(prompts)
        totals = np.stack([self.embed_tokens(p).sum(axis=0)
                           if p else np.zeros(self.kv_width,
                                              dtype=np.float32)
                           for p in prompts])
        outs: list[list[int]] = [[] for _ in range(n)]
        done = [False] * n
        for _ in range(max(int(m) for m in max_tokens) if n else 0):
            logits = self.partial_logits(totals)  # full batch, pads too
            toks = self.next_tokens(logits)
            u = self.embed_tokens([int(t) for t in toks])
            for i in range(n):
                if done[i]:
                    continue
                tok = int(toks[i])
                outs[i].append(tok)
                if tok == self.eos_token or \
                        len(outs[i]) >= int(max_tokens[i]):
                    done[i] = True
                else:
                    totals[i] = totals[i] + u[i]
            if all(done):
                break
        return outs

    def __call__(self, requests: list):
        """Request-level serving entry: one frozen lockstep batch per
        RPC (a whole generation blocks its slot)."""
        parsed = [parse_stream_request(r) for r in requests]
        return self.generate_batch([p for p, _, _, _ in parsed],
                                   [m for _, m, _, _ in parsed])

    __call__._serve_accept_batch = True  # takes the whole batch list


def parse_stream_request(data) -> tuple[list[int], int, str | None, bool]:
    """(prompt, max_tokens, session, stream?) from a request body: a
    dict ({"prompt": [...], "max_tokens": N, "session": s,
    "stream": bool}) or a bare token list."""
    if isinstance(data, dict):
        prompt = [int(t) for t in (data.get("prompt") or [])]
        return (prompt, int(data.get("max_tokens") or 16),
                data.get("session") or None, bool(data.get("stream")))
    if data is None:
        return [], 16, None, False
    return [int(t) for t in data], 16, None, False


# ---------------------------------------------------------------------------
# sequences and step plans
# ---------------------------------------------------------------------------


class Sequence:
    __slots__ = ("seq_id", "prompt", "max_tokens", "session", "generated",
                 "channel", "submitted_at", "admitted_at", "cached_tokens",
                 "prefix_tokens", "kv_sum", "trace_id")

    def __init__(self, seq_id: str, prompt: list[int], max_tokens: int,
                 session: str | None, channel: TokenChannel | None,
                 trace_id: str | None = None):
        self.seq_id = seq_id
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.session = session
        self.generated: list[int] = []
        self.channel = channel
        self.submitted_at = time.time()
        self.admitted_at = None
        self.cached_tokens = 0  # session-cache prefix reused at admit
        self.prefix_tokens = 0  # cross-session prefix adopted at admit
        # hex trace id of the submitting request (when sampled): the
        # decode-step histogram's exemplar link back to one stream
        self.trace_id = trace_id
        # running sum of this sequence's cached KV rows, maintained
        # incrementally (one page-table gather at admission, O(width)
        # per step after — the decode loop must not re-walk T pages per
        # token). Integer-valued f32 keeps it bit-equal to gather_sum.
        self.kv_sum = None


def _plan_wire(aborts, admits, batch) -> dict:
    return {"aborts": [(s, r) for s, r in aborts],
            "admits": [{"seq": s.seq_id, "prompt": s.prompt,
                        "max_tokens": s.max_tokens, "session": s.session}
                       for s in admits],
            "batch": list(batch)}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class DecodeEngine:
    """Token-level continuous-batching scheduler + paged-KV executor.

    `driver=True` (leader / unsharded replica): owns the decode thread,
    the waiting queue, the token channels and the plan. `driver=False`
    (follower mirror): pure executor — `apply_plan` is called once per
    step by the leader and replays the identical state transition on
    this rank's KV shard."""

    def __init__(self, model, config: dict, backend: str,
                 allreduce=None, peers=None, driver: bool = True,
                 on_dead=None):
        self._model = model
        self._backend = backend
        self._cfg = config
        self._allreduce = allreduce or (lambda x: x)
        self._peers = list(peers or [])
        self._driver = driver
        self._on_dead = on_dead
        width = getattr(model, "kv_width", None)
        if width is None:
            raise TypeError(
                f"streaming backend {backend!r} requires a model with "
                f"the decode protocol (kv_width/embed_tokens/"
                f"partial_logits); {type(model).__name__} lacks it")
        # cross-session prefix sharing: page-aligned
        # prompt prefixes index into the pool's radix tree; admission
        # adopts the longest match and prefills only the tail. Every
        # gang rank makes the same tree decisions from the same plan
        # stream, so sharing stays deterministic across ranks.
        self._prefix_sharing = bool(config.get("prefix_sharing", True))
        self._kv = PagedKVCache(
            int(config.get("kv_pages_total") or 512),
            int(config.get("kv_page_size") or 16),
            int(width), name=f"kv:{backend}",
            backend=config.get("kv_backend") or "numpy",
            prefix_max_nodes=(
                int(config.get("prefix_index_max_nodes") or 256)
                if self._prefix_sharing else 0))
        self._max_batch = int(config.get("max_decode_batch") or 8)
        self._max_waiting = int(config.get("max_waiting_sequences") or 32)
        self._session_max = int(config.get("session_cache_max") or 32)
        self._retry_after = float(
            config.get("overload_retry_after_s") or 1.0)
        self._lock = threading.Lock()
        self._running: dict[str, Sequence] = {}   # insertion = batch order
        self._waiting: list[Sequence] = []
        self._pending_aborts: list[tuple[str, str]] = []
        self._channels: dict[str, TokenChannel] = {}
        # retained session caches in LRU order (least-recently-finished
        # first): adoption pops the key, retire re-appends it, so
        # eviction is popitem(last=False) — O(1) under churn instead of
        # the old O(n) min()-scan per evicted entry
        self._sessions: OrderedDict[str, float] = OrderedDict()
        self._sessions_evicted = 0
        # engine-side LRU evictions the router hasn't heard about yet:
        # drained into the next stream_open reply (stream meta) so the
        # router prunes its sticky entry instead of pinning the session
        # to a replica that no longer holds its pages
        self._evicted_feedback: list[str] = []
        self._steps = 0
        self._tokens_emitted = 0
        self._last_step_at = time.time()
        self._dead: BaseException | None = None
        self._stopped = False
        self._wake = threading.Event()
        self._thread = None
        if driver:
            self._thread = threading.Thread(
                target=self._loop, name=f"decode-{backend}", daemon=True)
            self._thread.start()

    # -- driver surface (leader / unsharded replica) ---------------------

    def submit(self, prompt: list[int], max_tokens: int,
               session: str | None = None) -> str:
        """Queue one sequence for admission at the next step boundary.
        Sheds typed when the bounded waiting queue is full; raises the
        engine's death error (typed ReplicaGroupDied) once dead."""
        from ray_tpu_torch import exceptions as exc

        from ray_tpu_torch._private import tracing as _tracing

        seq_id = uuid.uuid4().hex[:12]
        ch = TokenChannel(seq_id)
        trace_id = _tracing.current_id()
        with self._lock:
            if self._dead is not None:
                raise self._dead
            if self._stopped:
                raise RuntimeError(
                    f"decode engine for {self._backend!r} is stopped")
            if len(self._waiting) >= self._max_waiting:
                raise exc.ServeOverloadedError(
                    self._backend, len(self._waiting), self._max_waiting,
                    self._retry_after)
            seq = Sequence(seq_id, list(prompt), int(max_tokens),
                           session, ch, trace_id=trace_id)
            self._waiting.append(seq)
            self._channels[seq_id] = ch
        self._wake.set()
        return seq_id

    def abort(self, seq_id: str, reason: str = "aborted") -> bool:
        """Abort a sequence wherever it is. Waiting: withdrawn outright.
        Running: queued into the next plan so every rank frees the same
        pages on the same step. Unknown/finished: no-op (idempotent —
        the disconnect path races the finish path)."""
        from ray_tpu_torch import exceptions as exc

        with self._lock:
            for i, s in enumerate(self._waiting):
                if s.seq_id == seq_id:
                    self._waiting.pop(i)
                    s.channel.finish(exc.SequenceAborted(seq_id, reason))
                    return True
            ch = self._channels.get(seq_id)
            if ch is not None and not ch.done:
                # running — or mid-admission between plan construction
                # and apply: the pending entry survives until the
                # sequence is visible in `running` (see _next_plan)
                self._pending_aborts.append((seq_id, reason))
                self._wake.set()
                return True
        return False

    def channel(self, seq_id: str) -> TokenChannel | None:
        return self._channels.get(seq_id)

    def session_info(self, session: str) -> dict:
        """Cached-session introspection (the affinity tests' truth)."""
        key = _SESSION_PREFIX + session
        return {"cached": self._kv.has(key),
                "tokens": self._kv.length(key)}

    # -- prefix economy ---------------------------------------------------

    def prefix_hashes(self, prompt: list[int]) -> list[str]:
        """Chained page-aligned prefix hashes of `prompt` — reported in
        the stream_open meta so the router can index which replica
        holds which prefixes (same function both sides: a hash computed
        here matches one computed from the same tokens anywhere)."""
        if not self._prefix_sharing:
            return []
        return prefix_block_hashes(prompt, self._kv.page_size)

    def drain_evicted_sessions(self) -> list[str]:
        """Session names LRU-evicted since the last drain (bounded at
        64) — piggybacked on stream_open replies so the router prunes
        its sticky table instead of routing to a cold cache forever."""
        with self._lock:
            out, self._evicted_feedback = self._evicted_feedback, []
        return out

    def export_prefix(self, max_pages: int = 128) -> list[dict]:
        """Hottest prefix-tree pages, parents-first (warm-start donor
        side; see PagedKVCache.export_prefix)."""
        return self._kv.export_prefix(max_pages)

    def import_prefix(self, entries: list[dict]) -> int:
        """Advisory warm import of a sibling's exported prefix pages;
        returns pages actually adopted (0 on any mismatch)."""
        n = self._kv.import_prefix(entries)
        if n:
            M_KV_WARM_PAGES.inc(n)
        return n

    # -- decode loop -----------------------------------------------------

    def _loop(self):
        import logging

        while not self._stopped and self._dead is None:
            plan = self._next_plan()
            if plan is None:
                self._wake.wait(timeout=0.1)
                self._wake.clear()
                self._reap_channels()
                continue
            t0 = time.perf_counter()
            try:
                self._exec_step(plan)
            except BaseException as e:
                if self._stopped:
                    break
                logging.getLogger("ray_tpu_torch.serve").exception(
                    "decode step failed; killing engine")
                self._die(e)
                break
            # measure the step BEFORE taking the engine lock: a submit
            # burst contending it must not inflate decode_step_s (the
            # decode stage reads its p99)
            step_s = time.perf_counter() - t0
            with self._lock:
                exemplar = next((s.trace_id
                                 for s in self._running.values()
                                 if s.trace_id), None)
                M_DECODE_BATCH.set(len(self._running))
                self._last_step_at = time.time()
            M_DECODE_STEP_S.observe(step_s, exemplar=exemplar)
            if self._steps % 256 == 0:
                # under sustained load the idle-path reap never runs;
                # finished channels must still age out
                self._reap_channels()

    def _next_plan(self) -> dict | None:
        with self._lock:
            aborts = [(s, r) for s, r in self._pending_aborts
                      if s in self._running]
            # keep aborts for sequences not yet visible in `running`
            # (admitted later this very step) alive for the next plan;
            # drop entries whose channel already finished
            self._pending_aborts = [
                (s, r) for s, r in self._pending_aborts
                if s not in self._running and s in self._channels
                and not self._channels[s].done]
            aborted = {s for s, _ in aborts}
            admits: list[Sequence] = []
            room = self._max_batch - (len(self._running) - len(aborted))
            while self._waiting and room > 0:
                admits.append(self._waiting.pop(0))
                room -= 1
            if not (self._running or admits or aborts):
                return None
            batch = [s for s in self._running if s not in aborted]
            batch.extend(s.seq_id for s in admits)
            return {"aborts": aborts, "admits": admits, "batch": batch,
                    "wire": _plan_wire(aborts, admits, batch)}

    def _exec_step(self, plan: dict):
        """One step: fan the plan to followers, apply locally (the
        allreduce inside meets theirs), then probe follower health the
        way handle_batch does."""
        from ray_tpu_torch import exceptions as exc

        refs = [p.decode_step_exec.remote(plan["wire"])
                for p in self._peers]
        try:
            self._apply_locked_step(plan["aborts"], plan["admits"],
                                    plan["batch"])
        except BaseException as e:
            if not self._peers:
                raise
            # a member died or errored before its allreduce: starved
            # group -> TimeoutError within the group timeout. Name the
            # follower failure when one already surfaced.
            raise exc.ReplicaGroupDied(
                self._backend, "",
                self._peer_failure(refs) or f"{type(e).__name__}: {e}"
            ) from e
        if self._peers:
            failure = self._peer_failure(refs)
            if failure:
                # a follower completed its allreduce but failed after
                # (or its reply was lost): op streams may be skewed
                raise exc.ReplicaGroupDied(self._backend, "", failure)

    def _peer_failure(self, refs, wait_s: float = 0.0) -> str:
        import ray_tpu_torch

        if not refs:
            return ""
        try:
            done, pending = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                         timeout=wait_s)
        except Exception as e:
            return f"{type(e).__name__}: {e}"
        for ref in done:
            try:
                ray_tpu_torch.get(ref, timeout=1.0)
            except BaseException as e:
                return f"follower failed: {type(e).__name__}: {e}"
        return ""

    # -- step application (every rank) -----------------------------------

    def apply_plan(self, wire: dict) -> bool:
        """Follower entry (decode_step_exec): replay one step from its
        wire form. Also fires the per-rank chaos seam."""
        aborts = list(wire.get("aborts") or [])
        admits = []
        for a in wire.get("admits") or []:
            s = Sequence(a["seq"], list(a["prompt"]),
                         int(a["max_tokens"]), a.get("session"), None)
            admits.append(s)
        self._apply_locked_step(aborts, admits, list(wire["batch"]))
        with self._lock:
            self._last_step_at = time.time()
        return True

    def _apply_locked_step(self, aborts, admits, batch):
        if _fp.ARMED:
            # the chaos kill point: `exit` here is a rank dying
            # mid-decode, starving every other rank's allreduce
            _fp.fire_strict("serve.decode_step")
        self._apply_aborts(aborts)
        self._apply_admits(admits)
        self._decode(batch)
        with self._lock:
            self._steps += 1

    def _apply_aborts(self, aborts):
        from ray_tpu_torch import exceptions as exc

        for item in aborts:
            seq_id, reason = item if isinstance(item, (tuple, list)) \
                else (item, "aborted")
            with self._lock:
                seq = self._running.pop(seq_id, None)
            self._kv.free(seq_id)
            if seq is not None and seq.channel is not None:
                seq.channel.finish(exc.SequenceAborted(seq_id, reason))

    def _apply_admits(self, admits):
        from ray_tpu_torch import exceptions as exc

        for seq in admits:
            adopted_key = None
            try:
                if seq.session and self._kv.has(
                        _SESSION_PREFIX + seq.session):
                    # warm session: adopt the cached prefix — the
                    # affinity hit skips re-prefilling prior turns
                    key = _SESSION_PREFIX + seq.session
                    seq.cached_tokens = self._kv.adopt(key, seq.seq_id)
                    adopted_key = key
                    with self._lock:
                        self._sessions.pop(key, None)
                elif self._prefix_sharing and seq.prompt:
                    # cold path: walk the prefix tree, adopt the
                    # longest indexed page-aligned prefix (refcount
                    # bumps, no prefill) — only the tail embeds below
                    seq.prefix_tokens = self._kv.adopt_prefix(
                        seq.seq_id, seq.prompt)
                else:
                    self._kv.alloc_table(seq.seq_id)
                tail = seq.prompt[seq.prefix_tokens:] \
                    if seq.prefix_tokens else seq.prompt
                if tail:
                    self._kv.append(seq.seq_id,
                                    self._model.embed_tokens(tail))
                if self._prefix_sharing and adopted_key is None \
                        and seq.prompt:
                    # index this prompt's full pages so later
                    # admissions (any session) adopt them
                    self._kv.register_prefix(seq.seq_id, seq.prompt)
            except KVCacheExhausted:
                # admission-time exhaustion is a SHED: the sequence
                # never ran; pages written for it go back — but an
                # ADOPTED session prefix is restored intact (truncate
                # the partial prompt rows, re-key back), or a
                # "retryable" shed would silently destroy the session
                if adopted_key is not None:
                    self._kv.truncate(seq.seq_id, seq.cached_tokens)
                    self._kv.adopt(seq.seq_id, adopted_key)
                    with self._lock:
                        self._sessions[adopted_key] = time.time()
                else:
                    self._kv.free(seq.seq_id)
                if seq.channel is not None:
                    seq.channel.finish(exc.ServeOverloadedError(
                        self._backend, self._kv.pages_in_use(),
                        self._kv.num_pages, self._retry_after))
                continue
            seq.admitted_at = time.time()
            # one page-table walk per admission (covers an adopted
            # session prefix + the fresh prompt rows)
            seq.kv_sum = self._kv.gather_sum(seq.seq_id)
            with self._lock:
                self._running[seq.seq_id] = seq

    def _decode(self, batch):
        from ray_tpu_torch import exceptions as exc

        with self._lock:
            seqs = [self._running[s] for s in batch
                    if s in self._running]
        if not seqs:
            # aborts/failed admits emptied the step: the gang still
            # meets in an allreduce so rank op streams stay aligned
            if self._peers or not self._driver:
                self._allreduce(np.zeros(1, dtype=np.float32))
            return
        sums = np.stack([s.kv_sum for s in seqs])
        partial = self._model.partial_logits(sums)
        logits = self._allreduce(np.asarray(partial, dtype=np.float32))
        toks = self._model.next_tokens(logits)
        # one embed call for the whole batch's next tokens (B python/
        # numpy round trips per step would dominate the toy-model step)
        u_all = self._model.embed_tokens([int(t) for t in toks])
        emitted = 0
        finished: list[Sequence] = []
        for i, (seq, tok) in enumerate(zip(seqs, toks)):
            tok = int(tok)
            seq.generated.append(tok)
            done = (tok == getattr(self._model, "eos_token", -1)
                    or len(seq.generated) >= seq.max_tokens)
            if not done or seq.session:
                # session-keyed finishes append the final token too, so
                # the retained cache holds the WHOLE turn for the next
                # one; anonymous finishes skip the write (freed below)
                try:
                    self._kv.append(seq.seq_id, u_all[i])
                    seq.kv_sum = seq.kv_sum + u_all[i]
                except KVCacheExhausted:
                    if not done:
                        # mid-decode exhaustion: abort THIS sequence
                        # typed, identically on every rank (same pool
                        # arithmetic everywhere)
                        with self._lock:
                            self._running.pop(seq.seq_id, None)
                        self._kv.free(seq.seq_id)
                        if seq.channel is not None:
                            seq.channel.push(tok)
                            seq.channel.finish(exc.SequenceAborted(
                                seq.seq_id, "KV page pool exhausted"))
                        continue
                    # finished anyway: retire without session retention
                    seq.session = None
            if seq.channel is not None:
                if seq.channel.first_token_at is None:
                    M_TTFT_S.observe(time.time() - seq.submitted_at,
                                     exemplar=seq.trace_id)
                seq.channel.push(tok)
                emitted += 1
            if done:
                finished.append(seq)
        if emitted:
            self._tokens_emitted += emitted
            M_TOKENS_TOTAL.inc(emitted)
        for seq in finished:
            with self._lock:
                self._running.pop(seq.seq_id, None)
            self._retire(seq)
            if seq.channel is not None:
                seq.channel.finish()

    def _retire(self, seq: Sequence):
        """Early-retire a finished sequence: session-keyed caches are
        RETAINED (LRU-bounded) for the next turn; anonymous ones free
        immediately."""
        if seq.session:
            key = _SESSION_PREFIX + seq.session
            self._kv.free(key)  # stale same-key cache, if any
            self._kv.adopt(seq.seq_id, key)
            with self._lock:
                # OrderedDict insertion order IS the LRU order (adoption
                # pops the key, retirement re-appends): eviction is an
                # O(1) popitem instead of a min() scan per victim
                self._sessions.pop(key, None)
                self._sessions[key] = time.time()
                evict = []
                while len(self._sessions) > self._session_max:
                    oldest, _ = self._sessions.popitem(last=False)
                    evict.append(oldest)
                self._sessions_evicted += len(evict)
                for victim in evict:
                    # feedback for the router: drained into the next
                    # stream_open reply so its sticky table prunes
                    # entries whose cache no longer exists
                    self._evicted_feedback.append(
                        victim[len(_SESSION_PREFIX):])
                del self._evicted_feedback[:-64]
            for victim in evict:
                self._kv.free(victim)
                M_SESSIONS_EVICTED_TOTAL.inc()
        else:
            self._kv.free(seq.seq_id)

    # -- death / shutdown -------------------------------------------------

    def _die(self, error: BaseException):
        """Terminal failure (starved allreduce = gang death): every open
        stream finishes TYPED, every KV page frees, the engine refuses
        new work with the same error. Zero leaked pages is the chaos
        invariant (`leak_report`)."""
        with self._lock:
            self._dead = error
            running = list(self._running.values())
            waiting = list(self._waiting)
            self._running.clear()
            self._waiting.clear()
        for seq in running + waiting:
            if seq.channel is not None:
                seq.channel.finish(error)
        self._kv.free_all()
        M_DECODE_BATCH.set(0)
        if self._on_dead is not None:
            try:
                self._on_dead(error)
            except Exception:
                pass

    def close(self):
        from ray_tpu_torch import exceptions as exc

        self._stopped = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        with self._lock:
            running = list(self._running.values())
            waiting = list(self._waiting)
            self._running.clear()
            self._waiting.clear()
        for seq in running + waiting:
            if seq.channel is not None:
                seq.channel.finish(exc.SequenceAborted(
                    seq.seq_id, "engine shutdown"))
        self._kv.close()

    def _reap_channels(self):
        now = time.time()
        with self._lock:
            stale = [s for s, ch in self._channels.items()
                     if ch.done and ch.finished_at
                     and now - ch.finished_at > CHANNEL_TTL_S]
            for s in stale:
                self._channels.pop(s, None)

    # -- introspection ----------------------------------------------------

    def debug_state(self) -> dict:
        """The decode-batch occupancy / KV / stream-backlog rows;
        `stall_age_s` is the decode stage's age (None while idle — an
        empty engine is not a wedged one)."""
        with self._lock:
            running = len(self._running)
            waiting = len(self._waiting)
            live = ([s for s in self._running]
                    + [s.seq_id for s in self._waiting]
                    + list(self._sessions))
            open_chs = [ch for ch in self._channels.values()
                        if not ch.done]
            backlog = sum(len(ch.tokens) - ch.consumed
                          for ch in self._channels.values())
            last = self._last_step_at
        return {
            "backend": self._backend,
            "decode_batch": running,
            "max_decode_batch": self._max_batch,
            "waiting": waiting,
            "steps": self._steps,
            "tokens_emitted": self._tokens_emitted,
            "open_streams": len(open_chs),
            "stream_backlog": backlog,
            "stall_age_s": (round(time.time() - last, 3)
                            if running else None),
            "sessions": {k[len(_SESSION_PREFIX):]: self._kv.length(k)
                         for k in self._sessions},
            "sessions_evicted": self._sessions_evicted,
            "kv": self._kv.debug_state(),
            "kv_leaked": self._kv.leak_report(live),
            "dead": repr(self._dead) if self._dead else "",
        }


# ---------------------------------------------------------------------------
# actor-facing host mixin (Replica and ReplicaGroupMember)
# ---------------------------------------------------------------------------


class StreamingEngineHost:
    """The stream API an engine-hosting actor exposes to routers.
    `stream_next` is ASYNC: it parks on the actor's event loop (like
    the controller's long-poll), so any number of open streams
    long-poll concurrently while sync methods keep dispatching."""

    _engine: DecodeEngine | None = None

    def _start_engine(self, model, config: dict, backend: str,
                      allreduce=None, peers=None, driver: bool = True):
        self._engine = DecodeEngine(model, config, backend,
                                    allreduce=allreduce, peers=peers,
                                    driver=driver)

    def _require_engine(self) -> DecodeEngine:
        if self._engine is None:
            raise RuntimeError(
                "this replica does not host a decode engine "
                "(deploy with BackendConfig(streaming=True))")
        return self._engine

    async def stream_open(self, data) -> dict:
        """Admit one sequence; returns its id plus `session_cached` —
        whether the session's KV prefix is warm on THIS replica
        (advisory, read at submit). A client sending only the new
        turn's delta tokens MUST check it: a cold session decodes from
        the delta alone, so the caller re-sends full history on a miss
        (eviction, restart, affinity fallback) instead of silently
        getting a different generation."""
        prompt, max_tokens, session, _ = parse_stream_request(data)
        eng = self._require_engine()
        cached = bool(session) and eng.session_info(session)["cached"]
        return {"seq": eng.submit(prompt, max_tokens, session),
                "session_cached": cached,
                # router-side prefix index feed: which page-aligned
                # prefixes this replica now holds, and which sessions
                # it LRU-evicted since the last report
                "prefix_hashes": eng.prefix_hashes(prompt),
                "evicted_sessions": eng.drain_evicted_sessions()}

    # once a stream is flowing, later chunks coalesce this long before
    # replying: one poll RPC then carries a step-burst of tokens instead
    # of one RPC per token. The FIRST chunk always returns immediately —
    # time-to-first-token never pays the coalescing window.
    STREAM_COALESCE_S = 0.05

    async def stream_next(self, seq_id: str, cursor: int,
                          wait_s: float = 2.0) -> dict:
        """Long-poll the sequence's channel past `cursor`. The reply
        embeds a terminal typed error (if any) AFTER the final tokens,
        so the router drains then re-raises."""
        import asyncio

        from ray_tpu_torch import exceptions as exc

        eng = self._require_engine()
        ch = eng.channel(seq_id)
        if ch is None:
            return {"tokens": [], "cursor": cursor, "done": True,
                    "error": exc.SequenceAborted(
                        seq_id, "unknown sequence (reaped or never "
                        "admitted on this replica)")}
        cursor = int(cursor)
        chunk = await ch.wait_async(cursor, float(wait_s))
        if cursor > 0 and chunk["tokens"] and not chunk["done"]:
            await asyncio.sleep(self.STREAM_COALESCE_S)
            chunk = ch.chunk(cursor)
        return chunk

    async def stream_abort(self, seq_id: str,
                           reason: str = "client disconnect") -> bool:
        eng = self._engine
        return eng.abort(seq_id, reason) if eng is not None else False

    def engine_state(self) -> dict:
        """Sync introspection hook (tests, chip_smoke), with the
        hosting process's pid."""
        import os

        eng = self._engine
        return ({**eng.debug_state(), "pid": os.getpid()}
                if eng is not None else {})

    def stats_snapshot(self, prefix: str = "serve.") -> dict:
        """This process's metrics whose names start with `prefix` (the
        TTFT and decode-step histograms live in the engine's process)."""
        from ray_tpu_torch._private import stats

        return {k: v for k, v in stats.snapshot().items()
                if k.startswith(prefix)}

    # -- scale-up warm start (controller-driven) --------------------------

    def export_prefix_pages(self, max_pages: int = 128) -> dict:
        """Warm-start DONOR: snapshot the hottest prefix-tree pages
        into the object store and return `{"ref": ..., "pages": n}`.
        The ref is relayed by the controller as a ~100-byte marker
        (nested refs rehydrate unresolved); the importer's `get` then
        reads the bytes from the store — the controller never touches
        the page data."""
        eng = self._require_engine()
        entries = eng.export_prefix(max_pages)
        if not entries:
            return {"ref": None, "pages": 0}
        import ray_tpu_torch

        return {"ref": ray_tpu_torch.put(entries), "pages": len(entries)}

    def import_prefix_pages(self, payload) -> int:
        """Warm-start IMPORTER (advisory): resolve a donor's export and
        seed the local prefix index so the first admissions hit warm
        pages instead of re-prefilling. Returns pages adopted; 0 on any
        mismatch, a lost donor, or a gang member — gang ranks replay
        the leader's admission stream and MUST NOT diverge in pool
        state, so only single-shard engines accept a warm import."""
        eng = self._require_engine()
        if eng._peers or not eng._driver:
            return 0
        ref = payload.get("ref") if isinstance(payload, dict) else None
        if ref is None:
            return 0
        import ray_tpu_torch

        try:
            entries = ray_tpu_torch.get(ref, timeout=30.0)
        except Exception:
            return 0  # donor died with the only copy: warm is advisory
        return eng.import_prefix(entries)
