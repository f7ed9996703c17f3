"""ObjectRef — a distributed future (reference: python/ray/_raylet.pyx
ObjectRef + ownership tracked by src/ray/core_worker/reference_count.h).

A ref is a handle to an object owned by some worker. Local handle lifetime
feeds the owner's reference count: creating/deserializing a ref registers
it, `__del__` releases it. Serializing a ref (into task args or a `put`)
goes through the core worker so the owner can pin the object until the
borrower registers.
"""

from __future__ import annotations

from ray_tpu_torch._private import global_state
from ray_tpu_torch._private.ids import ObjectID


class ObjectRef:
    __slots__ = ("_id", "_owner_addr", "_plasma", "_registered", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_addr: str = "",
                 plasma: bool = False, _register: bool = True):
        self._id = object_id
        self._owner_addr = owner_addr
        self._plasma = plasma
        self._registered = False
        if _register:
            cw = global_state.get_core_worker()
            if cw is not None:
                cw.register_ref(self)
                self._registered = True

    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def task_id(self):
        return self._id.task_id()

    @property
    def owner_address(self) -> str:
        return self._owner_addr

    def is_plasma(self) -> bool:
        return self._plasma

    def future(self):
        """An asyncio-compatible concurrent future for this ref."""
        cw = global_state.require_core_worker()
        return cw.as_future(self)

    def __await__(self):
        # resolve_async delivers through the loop's coalesced call queue:
        # a batch of N awaited results costs one loop wakeup, not N
        # (wrap_future(self.future()) paid one self-pipe write per ref).
        cw = global_state.require_core_worker()
        return cw.resolve_async(self).__await__()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        cw = global_state.get_core_worker()
        if cw is not None:
            desc = cw.serialize_ref(self)
        else:
            desc = {"id": self._id.binary(), "owner": self._owner_addr,
                    "plasma": self._plasma}
        return (_rehydrate_ref, (desc,))

    def __del__(self):
        try:
            if self._registered:
                cw = global_state.get_core_worker()
                if cw is not None:
                    cw.release_ref(self._id)
        except BaseException:
            # Interpreter shutdown can tear modules down under us.
            pass


def _rehydrate_ref(desc: dict) -> "ObjectRef":
    cw = global_state.get_core_worker()
    if cw is not None:
        return cw.deserialize_ref(desc)
    return ObjectRef(ObjectID(desc["id"]), desc.get("owner", ""),
                     desc.get("plasma", False), _register=False)
