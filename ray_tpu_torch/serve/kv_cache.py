"""Paged KV-cache for the streaming inference tier; port of
ray_tpu/serve/kv_cache.py (the vLLM PagedAttention idea sized for this
runtime).

One pool per decode engine (per gang RANK: each shard caches only its
own column-sharded slice of the per-token KV vectors, so an N-way gang
holds an N-way-partitioned cache with no cross-rank traffic on reads).
The pool is a single fixed arena of `num_pages` pages of `page_size`
token rows each; sequences own pages through a page table (logical
token index -> (page, slot)), so a sequence's cache grows in page-sized
quanta with zero copying and frees back to the pool the moment the
sequence finishes or aborts.

Cross-session prefix sharing: pages carry a REFCOUNT and the pool hosts
a radix tree over page-aligned token prefixes (the prefix index). A full
page is immutable once written, so identical page-aligned prefixes
prefill ONCE: admission walks the tree (`adopt_prefix`), adopts the
longest matching prefix by bumping page refcounts, and only the tail
tokens are embedded. `truncate`/`free`/tree eviction are refcount
decrements — a page returns to the free list only at refcount 0 — and a
write landing in a shared tail page (possible only after `truncate` into
a shared full page) COPIES the written rows to a fresh page first
(copy-on-write at the divergence point), so a reader never observes
another session's divergent rows. The tree itself holds one reference
per indexed page; under pool pressure the allocator reclaims index-only
pages leaf-first in deterministic LRU order (a logical clock, not wall
time — every gang rank applies the same op stream and must evict
identically).

Backends:
- "numpy" (the default, as in the reference): the arena is a host
  buffer; in-cluster pools place it in the same tmpfs as the object
  store's arena (`<session>/kvpool`), unlinked right after mapping, so a
  hard-killed member can never leak a segment file.
- "torch": the arena is one preallocated [num_pages, page_size, width]
  float32 tensor on the card, written in place. It lives on CUDA unless
  `device="cpu"` is given; without CUDA it raises, it never carries on
  on the host. An append writes its run of rows with one indexed store
  (the page tables, refcounts and rows are those of the per-row writes),
  a copy-on-write copies on the card, `gather_sum` sums the owner's
  pages on the card and brings back only the (width,) result, and
  `export_prefix`/`import_prefix` move only the pages they name. (The
  reference's "jax" backend writes one row per donated jit update and
  copies the whole arena to the host on each read.) It compiles
  nothing, so it has no counterpart of the jax backend's compile-cache
  seam `serve.kv_update`.

Page leaks are named by `leak_report()`.

Chaos seam: `serve.kv_page_alloc` fires on every page allocation.
"""

from __future__ import annotations

import hashlib
import os
import threading

import numpy as np

from ray_tpu_torch._private import failpoints as _fp
from ray_tpu_torch.serve.metrics import (M_KV_PAGES, M_KV_PAGES_SHARED,
                                         M_PREFIX_HITS, M_PREFIX_SAVED)

BACKENDS = ("numpy", "torch")


class KVCacheExhausted(RuntimeError):
    """The pool has no free page. Admission paths shed on this; decode
    paths abort the requesting sequence (typed SequenceAborted)."""

    def __init__(self, pool: str, num_pages: int):
        self.pool = pool
        self.num_pages = num_pages
        super().__init__(
            f"KV page pool {pool!r} exhausted ({num_pages} pages all "
            f"in use)")


def _arena_dir() -> str | None:
    """Directory beside the object store's arena for in-cluster pools;
    None outside a runtime — the pool then uses a plain anonymous
    buffer."""
    from ray_tpu_torch._private import global_state

    cw = global_state.get_core_worker()
    root = getattr(getattr(cw, "store", None), "root", None) if cw else None
    if not root:
        return None
    return os.path.join(os.path.dirname(os.path.normpath(root)), "kvpool")


def _alloc_arena(name: str, nbytes: int) -> np.ndarray:
    """Flat uint8 buffer for the numpy page arena: shm-file-backed beside
    the store arena when a runtime is up (unlinked after mapping — no leak
    path), else a plain numpy allocation."""
    d = None
    try:
        d = _arena_dir()
    except Exception:
        d = None
    if d is not None:
        try:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{name}-{os.getpid()}")
            buf = np.memmap(path, dtype=np.uint8, mode="w+",
                            shape=(max(nbytes, 1),))
            os.unlink(path)  # anonymous-by-unlink: survives only as long
            return buf       # as this mapping; a SIGKILL can't leak it
        except OSError:
            pass
    return np.zeros(max(nbytes, 1), dtype=np.uint8)


# -- prefix hashing ---------------------------------------------------------


def _chain_digest(prev: bytes, block) -> bytes:
    h = hashlib.blake2b(prev, digest_size=8)
    h.update(np.asarray(block, dtype=np.int64).tobytes())
    return h.digest()


def prefix_block_hashes(tokens, page_size: int,
                        max_blocks: int = 32) -> list[str]:
    """Chained hashes of the page-aligned token prefix: entry i covers
    tokens[0 : (i+1)*page_size]. The SAME function runs engine-side
    (stream meta) and router-side (prefix routing), so a hash match
    means the replica holds exactly that page-aligned prefix. Only FULL
    pages hash — a prefix shorter than one page has no shareable page
    and reports nothing."""
    if page_size < 1:
        return []
    out: list[str] = []
    d = b""
    n = min(len(tokens) // page_size, max_blocks)
    for i in range(n):
        d = _chain_digest(d, tokens[i * page_size:(i + 1) * page_size])
        out.append(d.hex())
    return out


class _PrefixNode:
    """One full page of the radix tree: `block` (the page's tokens) keys
    it under its parent, `page` is the arena page holding those tokens'
    KV rows (index-owned: one refcount held while the node lives)."""

    __slots__ = ("block", "page", "parent", "children", "stamp", "digest")

    def __init__(self, block: tuple, page: int,
                 parent: "_PrefixNode | None", digest: bytes):
        self.block = block
        self.page = page
        self.parent = parent
        self.children: dict[tuple, _PrefixNode] = {}
        self.stamp = 0
        self.digest = digest


class PageTable:
    """One sequence's (or cached session's) view of the pool: ordered
    page ids + the count of token rows written. Pages may be SHARED
    (refcount > 1) with other tables / the prefix index; full shared
    pages are read-only and a tail write copies first (CoW)."""

    __slots__ = ("owner", "pages", "length")

    def __init__(self, owner: str):
        self.owner = owner
        self.pages: list[int] = []
        self.length = 0


class PagedKVCache:
    """Fixed-size page pool + per-owner page tables (thread-safe: the
    engine thread appends while actor threads open/abort/inspect).

    `prefix_max_nodes` > 0 enables the prefix index (bounded node
    count); 0 keeps the pre-sharing behavior exactly (every page
    exclusively owned, refcounts degenerate to 0/1)."""

    def __init__(self, num_pages: int, page_size: int, width: int,
                 name: str = "kv", backend: str = "numpy",
                 prefix_max_nodes: int = 0, device=None):
        if num_pages < 1 or page_size < 1 or width < 1:
            raise ValueError("num_pages, page_size and width must be >= 1")
        if backend not in BACKENDS:
            raise ValueError(f"kv backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        self.name = name
        self.num_pages = num_pages
        self.page_size = page_size
        self.width = width
        self.backend = backend
        nbytes = num_pages * page_size * width * 4
        if backend == "torch":
            import torch

            self._pages = torch.zeros((num_pages, page_size, width),
                                      dtype=torch.float32,
                                      device=_torch_device(device))
        else:
            raw = _alloc_arena(name, nbytes)
            self._pages = np.frombuffer(
                raw, dtype=np.float32,
                count=num_pages * page_size * width).reshape(
                    num_pages, page_size, width)
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._tables: dict[str, PageTable] = {}
        self._lock = threading.Lock()
        # refcounts: tables + the prefix index each hold one ref per
        # page; a page is reusable only at refcount 0
        self._refs = [0] * num_pages
        self._index_flag = bytearray(num_pages)  # 1 = index holds a ref
        self._in_use = 0    # pages with >= 1 TABLE ref (the gauge)
        self._shared = 0    # pages with refcount > 1
        self._g_in_use = 0  # last values pushed to the process gauges
        self._g_shared = 0
        # prefix index (radix tree over page-aligned token prefixes)
        self._pref_max = max(0, int(prefix_max_nodes or 0))
        self._pref_root: dict[tuple, _PrefixNode] = {}
        self._pref_all: set[_PrefixNode] = set()
        self._pref_lookups = 0
        self._pref_hits = 0
        self._pref_tokens_saved = 0
        self._clock = 0  # deterministic LRU stamp (not wall time)

    # -- refcount plumbing (all under self._lock) ------------------------

    def _table_refs(self, page: int) -> int:
        return self._refs[page] - (1 if self._index_flag[page] else 0)

    def _incref_table(self, page: int):
        r = self._refs[page]
        if r - (1 if self._index_flag[page] else 0) == 0:
            self._in_use += 1
        if r == 1:
            self._shared += 1
        self._refs[page] = r + 1

    def _decref_table(self, page: int):
        r = self._refs[page] - 1
        self._refs[page] = r
        if r - (1 if self._index_flag[page] else 0) == 0:
            self._in_use -= 1
        if r == 1:
            self._shared -= 1
        elif r == 0:
            self._free.append(page)

    def _incref_index(self, page: int):
        r = self._refs[page]
        if r == 1:
            self._shared += 1
        self._refs[page] = r + 1
        self._index_flag[page] = 1

    def _decref_index(self, page: int):
        self._index_flag[page] = 0
        r = self._refs[page] - 1
        self._refs[page] = r
        if r == 1:
            self._shared -= 1
        elif r == 0:
            self._free.append(page)

    def _sync_gauges(self):
        # under self._lock; pushes only deltas so many pools per process
        # share the gauges without clobbering each other
        if self._in_use != self._g_in_use:
            M_KV_PAGES.add(self._in_use - self._g_in_use)
            self._g_in_use = self._in_use
        if self._shared != self._g_shared:
            M_KV_PAGES_SHARED.add(self._shared - self._g_shared)
            self._g_shared = self._shared

    # -- allocation ------------------------------------------------------

    def alloc_table(self, owner: str) -> PageTable:
        with self._lock:
            if owner in self._tables:
                raise ValueError(f"owner {owner!r} already has a table")
            t = self._tables[owner] = PageTable(owner)
        return t

    def has(self, owner: str) -> bool:
        return owner in self._tables

    def adopt(self, old_owner: str, new_owner: str) -> int:
        """Re-key a table (session cache -> live sequence and back).
        Returns the token length carried over."""
        with self._lock:
            t = self._tables.pop(old_owner)
            t.owner = new_owner
            self._tables[new_owner] = t
            return t.length

    def _alloc_page(self) -> int:
        # under self._lock: a TABLE allocation (refcount 1). Pool
        # pressure reclaims index-only pages first — the prefix cache
        # must never turn into an exhaustion a cold pool wouldn't hit.
        if _fp.ARMED:
            _fp.fire_strict("serve.kv_page_alloc")
        if not self._free:
            self._pref_reclaim()
        if not self._free:
            raise KVCacheExhausted(self.name, self.num_pages)
        page = self._free.pop()
        self._refs[page] = 1
        self._in_use += 1
        return page

    def _copy_rows(self, src: int, dst: int, nrows: int):
        # under self._lock (torch: a copy on the arena's device)
        self._pages[dst, :nrows] = self._pages[src, :nrows]

    @property
    def nbytes(self) -> int:
        """Bytes of the page arena."""
        return self.num_pages * self.page_size * self.width * 4

    def append(self, owner: str, vectors) -> None:
        """Write `vectors` ((T, width) float32) as the owner's next T
        token rows, allocating pages on demand. Raises KVCacheExhausted
        with the table intact (already-written rows stay valid) when the
        pool runs dry — the caller aborts/sheds and frees. A shared tail
        page (refcount > 1: reachable only by truncating into a shared
        full page) is copied before the write — divergence never mutates
        rows another owner reads."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        # torch: the rows' (page, slot) are planned row by row as the
        # numpy arena writes them, then stored with one indexed write
        on_card = self.backend == "torch"
        pages, slots = [], []
        with self._lock:
            t = self._tables[owner]
            try:
                for row in vectors:
                    slot = t.length % self.page_size
                    if slot == 0:
                        t.pages.append(self._alloc_page())
                    elif self._refs[t.pages[-1]] > 1:
                        # copy-on-write at the divergence point
                        fresh = self._alloc_page()
                        self._copy_rows(t.pages[-1], fresh, slot)
                        self._decref_table(t.pages[-1])
                        t.pages[-1] = fresh
                    page = t.pages[-1]
                    if on_card:
                        pages.append(page)
                        slots.append(slot)
                    else:
                        self._pages[page, slot] = row
                    t.length += 1
            finally:
                if pages:
                    # the rows written before an exhaustion stay valid
                    self._write_rows(pages, slots, vectors[:len(pages)])
                self._sync_gauges()

    def _write_rows(self, pages, slots, rows):
        # under self._lock, torch backend: arena[pages[i], slots[i]] =
        # rows[i], one host-to-device copy and one indexed store
        import torch

        dev = self._pages.device
        self._pages[torch.tensor(pages, device=dev),
                    torch.tensor(slots, device=dev)] = self._to_arena(rows)

    def _to_arena(self, rows):
        # a host float32 array as a tensor on the torch arena's device
        import torch

        return torch.from_numpy(np.ascontiguousarray(rows)).to(
            self._pages.device)

    def gather_sum(self, owner: str):
        """Sum of the owner's cached token rows ((width,) float32) — the
        read path of the reference model's decode step (page-table
        indirection: full pages summed whole, the tail page masked)."""
        with self._lock:
            t = self._tables[owner]
            out = np.zeros(self.width, dtype=np.float32)
            if not t.pages:
                return out
            full, tail = divmod(t.length, self.page_size)
            if self.backend == "torch":
                return self._gather_sum_torch(t.pages, full, tail)
            pages = self._pages
            for page in t.pages[:full]:
                out += pages[page].sum(axis=0)
            if tail:
                out += pages[t.pages[full]][:tail].sum(axis=0)
            return out

    def _gather_sum_torch(self, table, full, tail):
        # under self._lock: the sum runs on the arena's device, whole
        # pages then the masked tail; only (width,) comes back
        import torch

        pages = self._pages
        out = torch.zeros(self.width, dtype=torch.float32,
                          device=pages.device)
        if full:
            idx = torch.tensor(table[:full], dtype=torch.long,
                               device=pages.device)
            out += pages.index_select(0, idx).sum(dim=1).sum(dim=0)
        if tail:
            out += pages[table[full], :tail].sum(dim=0)
        return out.cpu().numpy()

    def truncate(self, owner: str, length: int) -> int:
        """Drop the owner's rows past `length` (releasing now-empty tail
        pages — a refcount decrement: a page still shared with another
        table or the prefix index survives); returns pages released.
        Deterministic from the same arithmetic on every rank — the
        warm-session shed path restores an adopted prefix to exactly its
        pre-admission state."""
        import math

        with self._lock:
            t = self._tables[owner]
            if length >= t.length:
                return 0
            keep = math.ceil(length / self.page_size)
            tail = t.pages[keep:]
            del t.pages[keep:]
            for page in tail:
                self._decref_table(page)
            t.length = length
            self._sync_gauges()
            return len(tail)

    def length(self, owner: str) -> int:
        with self._lock:
            t = self._tables.get(owner)
            return t.length if t else 0

    def free(self, owner: str) -> int:
        """Release every page of `owner` (refcount decrements: shared
        pages survive for their other holders); returns the count (0
        for an unknown owner — free is idempotent: abort paths race
        finish paths and must both be safe to run)."""
        with self._lock:
            t = self._tables.pop(owner, None)
            if t is None:
                return 0
            n = len(t.pages)
            for page in t.pages:
                self._decref_table(page)
            t.pages.clear()
            self._sync_gauges()
        return n

    def free_all(self) -> int:
        with self._lock:
            owners = list(self._tables)
        n = sum(self.free(o) for o in owners)
        self.clear_prefix()
        return n

    def close(self):
        self.free_all()

    # -- prefix index (cross-session sharing) ----------------------------

    def adopt_prefix(self, owner: str, tokens) -> int:
        """Create `owner`'s table pre-populated with the longest
        page-aligned prefix of `tokens` the index holds (one refcount
        bump per adopted page — no copy, no prefill). Returns the
        adopted token count; the caller embeds only tokens[matched:]."""
        with self._lock:
            if owner in self._tables:
                raise ValueError(f"owner {owner!r} already has a table")
            t = self._tables[owner] = PageTable(owner)
            if self._pref_max <= 0 or not self._pref_root:
                self._pref_lookups += 1
                return 0
            self._pref_lookups += 1
            self._clock += 1
            ps = self.page_size
            cmap = self._pref_root
            matched: list[int] = []
            for i in range(len(tokens) // ps):
                node = cmap.get(tuple(int(x) for x
                                      in tokens[i * ps:(i + 1) * ps]))
                if node is None:
                    break
                node.stamp = self._clock
                matched.append(node.page)
                cmap = node.children
            if matched:
                for page in matched:
                    self._incref_table(page)
                t.pages = list(matched)
                t.length = len(matched) * ps
                self._pref_hits += 1
                self._pref_tokens_saved += t.length
                M_PREFIX_HITS.inc()
                M_PREFIX_SAVED.inc(t.length)
            self._sync_gauges()
            return t.length

    def register_prefix(self, owner: str, tokens) -> int:
        """Index `owner`'s full pages covering the page-aligned prefix
        of `tokens` (after a successful prefill): later admissions with
        the same prefix adopt them. The index holds ONE ref per indexed
        page, so indexed pages outlive the registering sequence; the
        node bound (and pool pressure) evicts leaf-first in LRU order.
        Returns nodes added."""
        with self._lock:
            if self._pref_max <= 0:
                return 0
            t = self._tables.get(owner)
            if t is None:
                return 0
            ps = self.page_size
            nblocks = min(len(tokens), t.length) // ps
            cmap = self._pref_root
            parent: _PrefixNode | None = None
            digest = b""
            added = 0
            path: set[int] = set()
            self._clock += 1
            for i in range(nblocks):
                block = tuple(int(x) for x in tokens[i * ps:(i + 1) * ps])
                digest = _chain_digest(digest, block)
                node = cmap.get(block)
                if node is None:
                    while (len(self._pref_all) >= self._pref_max
                           and self._evict_leaf(exclude=path)):
                        pass
                    if len(self._pref_all) >= self._pref_max:
                        break
                    node = _PrefixNode(block, t.pages[i], parent, digest)
                    cmap[block] = node
                    self._pref_all.add(node)
                    self._incref_index(node.page)
                    added += 1
                node.stamp = self._clock
                path.add(id(node))
                parent = node
                cmap = node.children
            self._sync_gauges()
            return added

    def _evict_leaf(self, exclude: set[int] = frozenset()) -> bool:
        # under self._lock: drop the least-recently-used LEAF node
        # (deterministic tie-break on the path digest — every gang rank
        # applies the same op stream and must evict the same node)
        best = None
        for node in self._pref_all:
            if node.children or id(node) in exclude:
                continue
            if best is None or (node.stamp, node.digest) < \
                    (best.stamp, best.digest):
                best = node
        if best is None:
            return False
        self._drop_node(best)
        return True

    def _drop_node(self, node: _PrefixNode):
        # under self._lock; node must be a leaf
        cmap = node.parent.children if node.parent is not None \
            else self._pref_root
        cmap.pop(node.block, None)
        self._pref_all.discard(node)
        self._decref_index(node.page)

    def _pref_reclaim(self):
        # under self._lock: free-list empty — evict index leaves until a
        # page actually frees (an evicted page still table-shared frees
        # nothing but stops blocking deeper leaves) or the index is dry
        while not self._free and self._evict_leaf():
            pass

    def clear_prefix(self) -> int:
        """Drop the whole index (engine death / shutdown: the chaos
        invariant is zero pages held by ANYTHING afterwards)."""
        with self._lock:
            n = len(self._pref_all)
            for node in self._pref_all:
                self._decref_index(node.page)
            self._pref_all.clear()
            self._pref_root = {}
            self._sync_gauges()
        return n

    def prefix_stats(self) -> dict:
        with self._lock:
            cached = sum(1 for node in self._pref_all
                         if self._refs[node.page] == 1)
            return {
                "enabled": self._pref_max > 0,
                "nodes": len(self._pref_all),
                "max_nodes": self._pref_max,
                "lookups": self._pref_lookups,
                "hits": self._pref_hits,
                "tokens_saved": self._pref_tokens_saved,
                "pages_cached": cached,
                "pages_shared": self._shared,
            }

    # -- warm start (hot prefix pages through the object store) ----------

    def export_prefix(self, max_pages: int = 128) -> list[dict]:
        """Hot index pages for a sibling replica's cache warm-up, BFS
        from the root (near-root pages are the most-shared prefixes;
        parents always precede children so the importer can rebuild the
        chain), recency-ordered within each node's children. Entries:
        {"parent": index into this list (-1 = root), "block": tokens,
        "rows": (page_size, width) float32}."""
        with self._lock:
            out: list[dict] = []
            picked: list[int] = []
            queue = [(n, -1) for n in sorted(
                self._pref_root.values(),
                key=lambda n: (-n.stamp, n.digest))]
            while queue and len(out) < max_pages:
                node, pidx = queue.pop(0)
                out.append({"parent": pidx, "block": list(node.block)})
                picked.append(node.page)
                my = len(out) - 1
                queue.extend((k, my) for k in sorted(
                    node.children.values(),
                    key=lambda n: (-n.stamp, n.digest)))
            rows = self._read_pages(picked)
            for e, r in zip(out, rows):
                e["rows"] = r
            return out

    def _read_pages(self, pages: list[int]) -> np.ndarray:
        # under self._lock: (len(pages), page_size, width) float32 on the
        # host, only the named pages (torch: one gather on the card)
        if self.backend != "torch":
            return self._pages[pages]
        import torch

        idx = torch.tensor(pages, dtype=torch.long, device=self._pages.device)
        return self._pages.index_select(0, idx).cpu().numpy()

    def import_prefix(self, entries: list[dict]) -> int:
        """Adopt exported prefix pages into this pool's index (warm
        start: the prefill compute rode the object store instead of
        being recomputed). Advisory — stops without error at the node
        bound or on pool pressure; never evicts live state to make
        room. Returns pages imported."""
        if self._pref_max <= 0:
            return 0
        added = 0
        with self._lock:
            nodes: list[_PrefixNode | None] = []
            self._clock += 1
            for e in entries:
                pidx = int(e.get("parent", -1))
                parent = (nodes[pidx]
                          if 0 <= pidx < len(nodes) else None)
                if pidx >= 0 and parent is None:
                    nodes.append(None)  # ancestor was skipped
                    continue
                block = tuple(int(x) for x in e["block"])
                if len(block) != self.page_size:
                    nodes.append(None)  # page-size mismatch: skip chain
                    continue
                cmap = (parent.children if parent is not None
                        else self._pref_root)
                node = cmap.get(block)
                if node is None:
                    rows = np.asarray(e["rows"], dtype=np.float32)
                    if rows.shape != (self.page_size, self.width) \
                            or len(self._pref_all) >= self._pref_max \
                            or not self._free:
                        nodes.append(None)
                        continue
                    page = self._free.pop()
                    self._refs[page] = 1
                    self._index_flag[page] = 1
                    if self.backend == "torch":
                        self._pages[page] = self._to_arena(rows)
                    else:
                        self._pages[page][:] = rows
                    digest = _chain_digest(
                        parent.digest if parent is not None else b"",
                        block)
                    node = _PrefixNode(block, page, parent, digest)
                    cmap[block] = node
                    self._pref_all.add(node)
                    added += 1
                node.stamp = self._clock
                nodes.append(node)
            self._sync_gauges()
        return added

    # -- introspection ---------------------------------------------------

    def pages_in_use(self) -> int:
        """Pages held by at least one TABLE (live sequences + retained
        sessions). Index-only pages are reclaimable cache, reported
        separately as pages_cached — they are not leaks and not in-use."""
        with self._lock:
            return self._in_use

    def owners(self) -> dict[str, int]:
        """owner -> page count (the per-session page-count rows)."""
        with self._lock:
            return {o: len(t.pages) for o, t in self._tables.items()}

    def leak_report(self, live_owners) -> list[dict]:
        """Tables whose owner is NOT in `live_owners` (live sequences +
        retained sessions): by construction the engine frees on finish/
        abort, so anything here is a leaked-page bug."""
        live = set(live_owners)
        with self._lock:
            return [{"owner": o, "pages": len(t.pages),
                     "tokens": t.length}
                    for o, t in self._tables.items()
                    if o not in live and t.pages]

    def debug_state(self) -> dict:
        with self._lock:
            cached = sum(1 for node in self._pref_all
                         if self._refs[node.page] == 1)
            lookups = self._pref_lookups
            hits = self._pref_hits
            out = {
                "name": self.name,
                "backend": self.backend,
                "arena_bytes": self.nbytes,
                "pages_total": self.num_pages,
                "pages_in_use": self._in_use,
                "pages_shared": self._shared,
                "pages_cached": cached,
                "page_size": self.page_size,
                "width": self.width,
                "owners": {o: len(t.pages)
                           for o, t in self._tables.items()},
                "prefix": {
                    "enabled": self._pref_max > 0,
                    "nodes": len(self._pref_all),
                    "max_nodes": self._pref_max,
                    "lookups": lookups,
                    "hits": hits,
                    "hit_rate": round(hits / lookups, 4) if lookups
                    else 0.0,
                    "tokens_saved": self._pref_tokens_saved,
                },
            }
        if self.backend == "torch":
            import torch

            dev = self._pages.device
            out["device"] = str(dev)
            if dev.type == "cuda":
                out["cuda_memory_allocated"] = torch.cuda.memory_allocated(
                    dev)
        return out


def _torch_device(device):
    """The torch arena's device: CUDA unless the caller names another;
    without CUDA it raises (the pool never carries on on the host)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "kv backend 'torch' keeps its arena on CUDA, and no CUDA "
                "device is visible (pass device='cpu' to run on the host)")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
