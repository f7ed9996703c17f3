"""ctypes front for the C++ shared-arena object store (store.cc).

Drop-in for LocalObjectStore (object_store.py): same create/seal/get/
delete/contains surface, but objects live inside ONE mmap'd arena managed
by the native slab allocator instead of a file per object — small-object
churn costs an allocation + memcpy, not create/unlink syscalls, and every
process on the node shares one coherent index (reference role: the plasma
store process + its dlmalloc arena, src/ray/object_manager/plasma/).
Measured on this image: 10MB put+get 3.3 -> 4.7 GB/s, 200KB objects
885 -> 1206/s vs the files backend.

Reader safety (why this can be the DEFAULT backend): every `get` takes a
native pin held by the returned buffer's exporter (_PinnedBlock); a
delete while pins are outstanding turns the slot into a zombie — gone
from lookups, block freed by the last release — so zero-copy views can
never read reused memory (the per-client Get/Release bookkeeping plasma
does in the reference, plasma/client.h). A crashed process leaks its
pins (bounded by what it had mapped); the arena is per-session, so the
leak dies with the session. The same pin/zombie mechanism is what makes
raylet spill-to-disk safe here (raylet.py _maybe_spill): spill deletes
after copying, and a delete under outstanding pins only zombifies."""

from __future__ import annotations

import ctypes
import mmap
import os
import sys

from ray_tpu_torch._private.ids import ObjectID

_lib = None
_lib_err: str | None = None


def _load():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    try:
        from ray_tpu_torch.native.build import build_library

        path = build_library("rts_store", ["store/store.cc"])
        if path is None:
            _lib_err = "no C++ compiler available"
            return None
        lib = ctypes.CDLL(path)
        lib.rts_open.restype = ctypes.c_void_p
        lib.rts_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                 ctypes.c_uint32]
        lib.rts_close.argtypes = [ctypes.c_void_p]
        lib.rts_create.restype = ctypes.c_uint64
        lib.rts_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint64]
        lib.rts_seal.restype = ctypes.c_int
        lib.rts_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rts_get.restype = ctypes.c_int
        lib.rts_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_uint64),
                                ctypes.POINTER(ctypes.c_uint64)]
        lib.rts_release.restype = ctypes.c_int
        lib.rts_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint64]
        lib.rts_contains.restype = ctypes.c_int
        lib.rts_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rts_delete.restype = ctypes.c_uint64
        lib.rts_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rts_stats.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_uint64)] * 3
        lib.rts_map_len.restype = ctypes.c_uint64
        lib.rts_map_len.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception as e:  # pragma: no cover - toolchain problems
        _lib_err = str(e)
        return None
    return _lib


def native_store_available() -> bool:
    return _load() is not None


class _ArenaBuffer:
    """Writable/readable zero-copy view into the arena mapping."""

    def __init__(self, view: memoryview, size: int):
        self.view = view[:size]
        self.size = size

    def close(self):
        try:
            self.view.release()
        except (BufferError, ValueError):
            pass


class _PinnedBlock:
    """Zero-copy reader view that holds an arena PIN for its lifetime.

    Buffer-protocol exporter (PEP 688): `memoryview(block)` and every
    slice of it share one export; when the LAST view is released —
    including numpy arrays deserialized zero-copy out of the payload —
    __release_buffer__ fires and drops the native pin, letting a
    deleted-while-read block (zombie) actually free. This is the
    per-client Release bookkeeping plasma does in the reference
    (plasma/client.h Get/Release)."""

    __slots__ = ("_store", "_oid", "_offset", "_view")

    def __init__(self, store: "NativeObjectStore", oid: bytes,
                 offset: int, view: memoryview):
        self._store = store
        self._oid = oid
        self._offset = offset  # names the exact block generation
        self._view = view

    def __buffer__(self, flags):
        return self._view

    def __release_buffer__(self, view):
        try:
            self._store._release(self._oid, self._offset)
        finally:
            try:
                self._view.release()
            except (BufferError, ValueError):
                pass



class NativeObjectStore:
    """LocalObjectStore-compatible backend over the C++ arena."""

    def __init__(self, root: str, capacity: int = 1 << 30,
                 max_objects: int = 1 << 16):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native store unavailable: {_lib_err}")
        os.makedirs(root, exist_ok=True)
        self.root = root
        self._path = os.path.join(root, "arena.rts")
        self._lib = lib
        self._h = lib.rts_open(self._path.encode(), capacity, max_objects)
        if not self._h:
            raise RuntimeError(f"rts_open failed for {self._path}")
        # One python-side mmap of the same file for memoryview access
        # (ctypes base pointers can't become memoryviews safely).
        fd = os.open(self._path, os.O_RDWR)
        try:
            self._map = mmap.mmap(fd, lib.rts_map_len(self._h))
        finally:
            os.close(fd)
        self._mv = memoryview(self._map)

    # -- LocalObjectStore surface ---------------------------------------

    def create(self, object_id: ObjectID, size: int) -> _ArenaBuffer:
        oid = object_id.binary()
        assert len(oid) == 24, f"ObjectID must be 24 bytes, got {len(oid)}"
        off = self._lib.rts_create(self._h, oid, size)
        if not off:
            # Files-backend semantics: a re-put of an existing (or
            # half-created) object overwrites it — e.g. a reconstructed
            # task re-producing its return. Drop the old entry and retry;
            # if the id wasn't present this is a no-op and the retry
            # distinguishes true OOM.
            self._lib.rts_delete(self._h, oid)
            off = self._lib.rts_create(self._h, oid, size)
        if not off:
            raise MemoryError(
                f"native store: cannot allocate {size} bytes for "
                f"{object_id.hex()[:12]} — the arena is full (the raylet "
                f"spills above object_spilling_threshold, but zombie "
                f"blocks pinned by live readers hold bytes until "
                f"released; raise object_store_memory for headroom)")
        return _ArenaBuffer(self._mv[off:off + size], size)

    def seal(self, object_id: ObjectID) -> None:
        if self._lib.rts_seal(self._h, object_id.binary()) != 0:
            raise KeyError(f"seal of unknown object {object_id.hex()[:12]}")

    def abort(self, object_id: ObjectID) -> None:
        self._lib.rts_delete(self._h, object_id.binary())

    def _release(self, oid: bytes, offset: int):
        if self._h:
            self._lib.rts_release(self._h, oid, offset)

    def get(self, object_id: ObjectID) -> _ArenaBuffer | None:
        """Pinned zero-copy read: the returned buffer (and anything
        deserialized out of it) holds a native pin until every view
        dies, so owner-driven deletes can never corrupt live readers
        (they defer via zombie blocks)."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        oid = object_id.binary()
        rc = self._lib.rts_get(self._h, oid,
                               ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            return None
        raw = self._mv[off.value:off.value + size.value]
        if sys.version_info >= (3, 12):
            pinned = _PinnedBlock(self, oid, off.value, raw)
            return _ArenaBuffer(memoryview(pinned), size.value)
        # Python < 3.12 cannot export the buffer protocol from pure
        # Python (PEP 688), so the pinned zero-copy path is unavailable:
        # copy the payload out and drop the pin immediately. One memcpy
        # slower than 3.12, but views can never see reused arena memory.
        try:
            data = bytes(raw)
        finally:
            raw.release()
            self._release(oid, off.value)
        return _ArenaBuffer(memoryview(data), size.value)

    def delete(self, object_id: ObjectID) -> int:
        return int(self._lib.rts_delete(self._h, object_id.binary()))

    def put_serialized(self, object_id: ObjectID, header: bytes,
                       buffers: list[memoryview]) -> int:
        total = len(header) + sum(b.nbytes for b in buffers)
        buf = self.create(object_id, total)
        try:
            view = buf.view
            view[:len(header)] = header
            off = len(header)
            for b in buffers:
                flat = b.cast("B") if (b.ndim != 1 or b.format != "B") else b
                view[off:off + flat.nbytes] = flat
                off += flat.nbytes
            buf.close()
            self.seal(object_id)
        except BaseException:
            buf.close()
            self.abort(object_id)
            raise
        return total

    def put_bytes(self, object_id: ObjectID, data) -> int:
        return self.put_serialized(object_id, b"",
                                   [memoryview(data).cast("B")])

    def stats(self) -> dict:
        cap = ctypes.c_uint64()
        used = ctypes.c_uint64()
        n = ctypes.c_uint64()
        self._lib.rts_stats(self._h, ctypes.byref(cap), ctypes.byref(used),
                            ctypes.byref(n))
        return {"capacity": cap.value, "used": used.value,
                "num_objects": n.value}

    def close(self):
        try:
            self._mv.release()
            self._map.close()
        except (BufferError, ValueError):
            pass
        if self._h:
            self._lib.rts_close(self._h)
            self._h = None
