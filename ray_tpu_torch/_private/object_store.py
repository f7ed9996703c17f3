"""Node-local shared-memory object store (the plasma equivalent).

Capability parity with the reference's plasma store (reference:
src/ray/object_manager/plasma/store.h:53, client.h) with a TPU-host-native
design instead of a store server process + fd passing: each sealed object is
one file under <store root>/objects (default_store_root), created as `<hex>.build`, written
through mmap, and sealed by an atomic rename. Any process on the node mmaps
sealed objects read-only — creation and reads are zero-copy and lock-free;
there is no store server in the data path at all. Capacity accounting,
eviction, and spill-to-disk live in the raylet's LocalObjectManager
(reference: src/ray/raylet/local_object_manager.h), which is the only
deleter. A C++ slab-allocator backend can replace the file-per-object layout
behind this same interface (see native/store).
"""

from __future__ import annotations

import hashlib
import mmap
import os
import tempfile

from ray_tpu_torch._private.ids import ObjectID


class ObjectBuffer:
    """A writable or read-only mmap view of one object."""

    def __init__(self, path: str, size: int, create: bool):
        self.path = path
        self.size = size
        if create:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, size)
                self._mmap = mmap.mmap(fd, size) if size else None
            finally:
                os.close(fd)
        else:
            fd = os.open(path, os.O_RDONLY)
            try:
                size = os.fstat(fd).st_size
                self.size = size
                self._mmap = (
                    mmap.mmap(fd, size, prot=mmap.PROT_READ) if size else None
                )
            finally:
                os.close(fd)
        self.view = memoryview(self._mmap) if self._mmap else memoryview(b"")

    def close(self):
        try:
            self.view.release()
            if self._mmap is not None:
                self._mmap.close()
        except (BufferError, ValueError):
            # Still-referenced views keep the mapping alive; the OS reclaims
            # on process exit.
            pass


class LocalObjectStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, object_id: ObjectID) -> str:
        return os.path.join(self.root, object_id.hex())

    def create(self, object_id: ObjectID, size: int) -> ObjectBuffer:
        return ObjectBuffer(self._path(object_id) + ".build", size, create=True)

    def seal(self, object_id: ObjectID) -> None:
        os.rename(self._path(object_id) + ".build", self._path(object_id))

    def abort(self, object_id: ObjectID) -> None:
        try:
            os.unlink(self._path(object_id) + ".build")
        except FileNotFoundError:
            pass

    def get(self, object_id: ObjectID) -> ObjectBuffer | None:
        try:
            return ObjectBuffer(self._path(object_id), 0, create=False)
        except FileNotFoundError:
            return None

    def size_of(self, object_id: ObjectID) -> int:
        return os.stat(self._path(object_id)).st_size

    def delete(self, object_id: ObjectID) -> int:
        """Returns freed bytes."""
        try:
            size = self.size_of(object_id)
            os.unlink(self._path(object_id))
            return size
        except FileNotFoundError:
            return 0

    def put_serialized(self, object_id: ObjectID, header: bytes,
                       buffers: list[memoryview]) -> int:
        """Write header+buffers and seal. Returns total size.

        Uses one writev() straight from the caller's buffers instead of
        an mmap write: tmpfs pages are then allocated inside the kernel
        in one pass rather than via ~2.5k user-space page faults per
        10MB (measured ~1.5x faster), and nothing is copied in user
        space."""
        total = len(header) + sum(b.nbytes for b in buffers)
        path = self._path(object_id) + ".build"
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o600)
        try:
            iov = [memoryview(header)]
            iov += [b.cast("B") if (b.ndim != 1 or b.format != "B") else b
                    for b in buffers]
            iov = [b for b in iov if b.nbytes]
            written = 0
            # IOV_MAX (1024 on Linux) caps vectors per writev; objects
            # with thousands of out-of-band buffers go in slices.
            iov_max = 1024
            while iov:
                n = os.writev(fd, iov[:iov_max])
                written += n
                if written >= total:
                    break
                # partial write: drop fully-written buffers, slice the rest
                while iov and n >= iov[0].nbytes:
                    n -= iov[0].nbytes
                    iov.pop(0)
                if iov and n:
                    iov[0] = iov[0][n:]
            os.close(fd)
            self.seal(object_id)
        except BaseException:
            try:
                os.close(fd)
            except OSError:
                pass
            self.abort(object_id)
            raise
        return total

    def put_bytes(self, object_id: ObjectID, data: bytes | memoryview) -> int:
        return self.put_serialized(object_id, b"", [memoryview(data).cast("B")])


def make_store(root: str, config=None):
    """Backend factory: the C++ shared-arena slab store (native/store —
    pinned zero-copy reads make deletion safe), or the python
    file-per-object store when no C++ toolchain is present. Raylet and
    workers on one node must agree; the fallback is deterministic per
    box (same compiler probe), so they do."""
    from ray_tpu_torch.native.store import native_store_available

    if native_store_available():
        # Any failure past this point must be FATAL, not a fallback:
        # a per-process fallback would split one node across two
        # incompatible backends (raylet arena vs worker files) and
        # every cross-process get would hang.
        from ray_tpu_torch.native.store import NativeObjectStore

        capacity = getattr(config, "object_store_memory", 1 << 30)
        return NativeObjectStore(root, capacity=capacity)
    import logging

    logging.getLogger("ray_tpu_torch").warning(
        "native object store unavailable (no C++ toolchain / build "
        "failure — deterministic per box); using the "
        "file-per-object backend")
    return LocalObjectStore(root)


def session_root() -> str:
    """Where sessions live: $RAY_TPU_TORCH_TMPDIR, else `ray_tpu_torch`
    under the tempdir (which follows TMPDIR)."""
    return (os.environ.get("RAY_TPU_TORCH_TMPDIR")
            or os.path.join(tempfile.gettempdir(), "ray_tpu_torch"))


def shm_root(sessions: str) -> str:
    """The /dev/shm directory of the sessions under `sessions`, named
    after that directory: two runtimes with different tempdirs never
    share one."""
    tag = hashlib.sha1(os.path.abspath(sessions).encode()).hexdigest()[:12]
    return os.path.join("/dev/shm", f"ray_tpu_torch-{tag}")


def default_store_root(session_dir: str, capacity: int = 0) -> str:
    """Prefer /dev/shm (true shared memory) when it is writable and has
    room for the store's capacity: a container's /dev/shm is often 64 MB,
    and an arena past it would fault on first touch. Else the session
    directory itself."""
    shm = "/dev/shm"
    if (os.path.isdir(shm) and os.access(shm, os.W_OK)
            and shm_free_bytes() >= capacity):
        base = os.path.join(shm_root(os.path.dirname(session_dir)),
                            os.path.basename(session_dir))
    else:
        base = os.path.join(session_dir, "store")
    return os.path.join(base, "objects")


def shm_free_bytes() -> int:
    """Bytes free on /dev/shm (0 when it is absent)."""
    try:
        st = os.statvfs("/dev/shm")
    except OSError:
        return 0
    return st.f_bavail * st.f_frsize
