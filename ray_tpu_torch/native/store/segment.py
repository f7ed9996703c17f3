"""Shared-memory scratch segments for the collective data plane; port
of ray_tpu/native/store/segment.py.

Extends the native arena's placement — the same /dev/shm session
directory whose tmpfs pages make the object store do multi-GB/s — with a
segment-allocation API that skips the object-id/pin machinery entirely:
a collective segment is group-private scratch with its own lifecycle
(created by rank 0, mapped by every rank on the node, unlinked on group
destroy), not an object anyone else can look up. When no runtime store
is up (bare HostGroup in tests) the segment falls back to a plain mmap
file under /dev/shm, or the tempdir as a last resort.

The returned mapping is MAP_SHARED on one tmpfs file, so every process
that opens it sees one coherent set of physical pages — stores by one
rank are loads for the others with zero syscalls in between. That
coherence claim only holds for node-local filesystems; callers gate on
node identity (and /dev/shm placement) before trusting it.
"""

from __future__ import annotations

import mmap
import os
import tempfile


def segment_dir() -> str:
    """Directory for collective segments: beside the session's store
    arena when a runtime is up (same tmpfs, same lifecycle: the session's
    shutdown removes it), else the tempdir."""
    from ray_tpu_torch._private import global_state

    cw = global_state.get_core_worker()
    root = getattr(getattr(cw, "store", None), "root", None)
    if root:
        return os.path.join(os.path.dirname(os.path.abspath(root)),
                            "colseg")
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch_colseg")


def is_shared_memory_path(path: str) -> bool:
    """True when `path` lives on a filesystem we trust to be node-local
    shared memory (tmpfs under /dev/shm)."""
    return os.path.abspath(path).startswith("/dev/shm/")


class SharedSegment:
    """One mmap'd scratch file shared by every rank on a node."""

    def __init__(self, path: str, size: int, create: bool):
        self.path = path
        self.size = size
        self.owner = create
        if create:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        else:
            fd = os.open(path, os.O_RDWR)
        try:
            if create:
                # Reserve capacity NOW: a sparse ftruncate on a tmpfs
                # near its limit would mmap fine and then SIGBUS (an
                # uncatchable rank death) on the first write past the
                # fs limit; fallocate turns that into a clean ENOSPC
                # the caller converts into a transport fallback.
                try:
                    os.posix_fallocate(fd, 0, size)
                except OSError:
                    os.unlink(path)  # enclosing finally closes fd
                    raise
            elif os.fstat(fd).st_size < size:
                raise ValueError(
                    f"segment {path} is {os.fstat(fd).st_size} bytes, "
                    f"need {size}")
            self._map = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.view = memoryview(self._map)

    def close(self, unlink: bool | None = None):
        """Release the mapping; the creator also unlinks the file by
        default (tmpfs bytes are freed when the last mapping dies)."""
        try:
            self.view.release()
            self._map.close()
        except (BufferError, ValueError):
            pass  # outstanding numpy views keep the mapping alive
        if unlink is None:
            unlink = self.owner
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


def create_segment(name: str, size: int) -> SharedSegment:
    return SharedSegment(os.path.join(segment_dir(), name), size,
                         create=True)


def open_segment(path: str, size: int) -> SharedSegment:
    return SharedSegment(path, size, create=False)
