"""Binary IDs for jobs, tasks, actors, objects, nodes, placement groups.

Capability parity with the reference's ID scheme (reference:
src/ray/common/id.h, src/ray/design_docs/id_specification.md) but simplified:
every ID is a fixed-width random byte string; ObjectIDs embed the creating
TaskID plus a return/put index so lineage is recoverable from the ID alone.

Sizes (bytes): JobID=4, ActorID=12 (job-suffixed), TaskID=16, ObjectID=24
(TaskID + 4-byte kind/index + 4 random), NodeID/WorkerID/PlacementGroupID=16.
"""

from __future__ import annotations

import os
import random
import struct
import threading

_JOB_ID_SIZE = 4
_ACTOR_ID_SIZE = 12
_TASK_ID_SIZE = 16
_OBJECT_ID_SIZE = 24
_UNIQUE_ID_SIZE = 16

# Object "kind" tags baked into the index word of an ObjectID.
_KIND_PUT = 1
_KIND_RETURN = 2

# Hot-path randomness: ids need collision resistance, not secrecy, and
# os.urandom is a ~50µs syscall that showed up at 5% of the actor-call
# microbenchmark. One urandom-seeded Mersenne Twister per process (and
# per fork — reseeded via the pid guard) is plenty.
_rng_lock = threading.Lock()
_rng = random.Random(os.urandom(16))
_rng_pid = os.getpid()


def _rand_bytes(n: int) -> bytes:
    global _rng, _rng_pid
    with _rng_lock:
        if os.getpid() != _rng_pid:  # forked child must not clone ids
            _rng = random.Random(os.urandom(16))
            _rng_pid = os.getpid()
        return _rng.getrandbits(n * 8).to_bytes(n, "big")


class BaseID:
    SIZE = _UNIQUE_ID_SIZE
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if not isinstance(id_bytes, bytes) or len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {id_bytes!r}"
            )
        self._bytes = id_bytes
        self._hash = hash(id_bytes)

    @classmethod
    def from_random(cls):
        return cls(_rand_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = _JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int):
        return cls(struct.pack(">I", value))


class WorkerID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class NodeID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class ActorID(BaseID):
    SIZE = _ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID):
        return cls(_rand_bytes(cls.SIZE - JobID.SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[-JobID.SIZE :])


class TaskID(BaseID):
    SIZE = _TASK_ID_SIZE

    @classmethod
    def for_driver(cls, job_id: JobID):
        return cls(b"\x00" * (cls.SIZE - JobID.SIZE) + job_id.binary())

    @classmethod
    def for_task(cls, job_id: JobID):
        return cls(_rand_bytes(cls.SIZE - JobID.SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[-JobID.SIZE :])


class ObjectID(BaseID):
    SIZE = _OBJECT_ID_SIZE

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int):
        tag = struct.pack(">I", (_KIND_PUT << 24) | (put_index & 0xFFFFFF))
        return cls(task_id.binary() + tag + _rand_bytes(4))

    @classmethod
    def for_return(cls, task_id: TaskID, return_index: int):
        # Deterministic: a task's i-th return ObjectID is computable by anyone
        # holding the TaskID (used for lineage-based recovery).
        tag = struct.pack(">I", (_KIND_RETURN << 24) | (return_index & 0xFFFFFF))
        return cls(task_id.binary() + tag + b"\x00\x00\x00\x00")

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def return_index(self) -> int:
        (word,) = struct.unpack(">I", self._bytes[TaskID.SIZE : TaskID.SIZE + 4])
        return word & 0xFFFFFF
