"""ActorClass / ActorHandle / ActorMethod (reference: python/ray/actor.py:
ActorClass :297, ._remote :477, ActorHandle :723, ActorMethod :62,
exit_actor :1035)."""

from __future__ import annotations

import cloudpickle

from ray_tpu_torch._private import global_state
from ray_tpu_torch._private.common import check_num_gpus
from ray_tpu_torch._private.ids import ActorID


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        # static spec prefix cached per (handle, method, core worker) —
        # see CoreWorker.make_actor_task_template
        self._template = None
        self._template_cw = None

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name!r} cannot be called directly; "
            f"use .{self._method_name}.remote()."
        )

    def __getstate__(self):
        # ActorMethods can be captured in closures shipped to other
        # processes; the template cache references this process's
        # CoreWorker and must not travel.
        state = self.__dict__.copy()
        state["_template"] = None
        state["_template_cw"] = None
        return state

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, {})

    def options(self, **opts):
        parent = self

        class _Wrapped:
            def remote(self, *args, **kwargs):
                return parent._remote(args, kwargs, opts)

        return _Wrapped()

    def _remote(self, args, kwargs, opts):
        cw = global_state.require_core_worker()
        num_returns = opts.get("num_returns", self._num_returns)
        if not opts:
            if self._template is None or self._template_cw is not cw:
                self._template = cw.make_actor_task_template(
                    self._handle._actor_id.binary(),
                    fn_id=self._handle._cls_id,
                    name=f"{self._handle._class_name}.{self._method_name}",
                    method_name=self._method_name,
                    num_returns=num_returns,
                )
                self._template_cw = cw
            refs = cw.submit_actor_task(
                self._handle._actor_id.binary(), args=args, kwargs=kwargs,
                template=self._template)
        else:
            refs = cw.submit_actor_task(
                self._handle._actor_id.binary(),
                fn_id=self._handle._cls_id,
                name=f"{self._handle._class_name}.{self._method_name}",
                method_name=self._method_name,
                args=args,
                kwargs=kwargs,
                num_returns=num_returns,
            )
        if num_returns == 0:
            return None
        if num_returns == 1:
            return refs[0]
        return refs


class ActorHandle:
    def __init__(self, actor_id: ActorID, cls_id: bytes, class_name: str,
                 method_num_returns: dict[str, int] | None = None):
        self._actor_id = actor_id
        self._cls_id = cls_id
        self._class_name = class_name
        self._method_num_returns = method_num_returns or {}

    def __getattr__(self, name):
        # __ray_*__ system methods (terminate, collective init) are callable
        # remotely; other underscore names are not exposed as actor methods.
        if name.startswith("_") and not name.startswith("__ray_"):
            raise AttributeError(name)
        method = ActorMethod(self, name, self._method_num_returns.get(name, 1))
        # Cache on the instance so repeated `handle.method` lookups skip
        # __getattr__ (and keep the method's cached spec template alive);
        # __reduce__ serializes explicit state only, so the cache never
        # travels.
        self.__dict__[name] = method
        return method

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        state = {
            "actor_id": self._actor_id.binary(),
            "cls_id": self._cls_id,
            "class_name": self._class_name,
            "method_num_returns": self._method_num_returns,
        }
        return (_rehydrate_handle, (state,))

    def __ray_terminate__(self):
        """Gracefully stop this actor (queued behind pending tasks)."""
        return ActorMethod(self, "__ray_terminate__", 0).remote()


def _rehydrate_handle(state) -> ActorHandle:
    return ActorHandle(
        ActorID(state["actor_id"]),
        state["cls_id"],
        state["class_name"],
        state.get("method_num_returns"),
    )


class ActorClass:
    def __init__(self, cls, *, num_cpus=None, num_gpus=None, resources=None,
                 max_restarts=0, max_concurrency=1):
        self._cls = cls
        self._class_name = cls.__name__
        self._num_cpus = num_cpus
        self._num_gpus = check_num_gpus(num_gpus)
        self._resources = resources or {}
        self._max_restarts = max_restarts
        self._max_concurrency = max_concurrency
        self._pickled = None
        self._cls_id = None

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._class_name} cannot be instantiated directly;"
            f" use {self._class_name}.remote()."
        )

    def options(self, **opts):
        parent = self

        class _Wrapped:
            def remote(self, *args, **kwargs):
                return parent._remote(args, kwargs, opts)

        return _Wrapped()

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, {})

    def _remote(self, args, kwargs, opts) -> ActorHandle:
        cw = global_state.require_core_worker()
        if self._cls_id is None:
            cls = _prepare_actor_class(self._cls)
            self._pickled = cloudpickle.dumps(cls)
        cls_id = cw.export_function(self._pickled, kind="cls")
        self._cls_id = cls_id
        resources = dict(self._resources)
        resources.update(opts.get("resources") or {})
        num_cpus = opts.get("num_cpus", self._num_cpus)
        num_gpus = check_num_gpus(opts.get("num_gpus", self._num_gpus))
        # Reference semantics: actors without an explicit request hold no
        # CPU while alive (so long-lived actors don't starve task
        # scheduling); an explicit num_cpus — or an explicit "CPU" key in
        # resources= — is held for the actor's lifetime.
        if num_cpus is not None:
            resources["CPU"] = num_cpus
        elif "CPU" not in resources:
            resources["CPU"] = 0
        if num_gpus:
            resources["GPU"] = num_gpus
        pg = opts.get("placement_group")
        actor_id = cw.create_actor(
            cls_id=cls_id,
            name=self._class_name,
            args=args,
            kwargs=kwargs,
            resources=resources,
            max_restarts=opts.get("max_restarts", self._max_restarts),
            max_concurrency=opts.get("max_concurrency",
                                     self._max_concurrency),
            actor_name=opts.get("name", ""),
            namespace=opts.get("namespace", ""),
            placement_group=pg.id.binary() if pg is not None else None,
            bundle_index=opts.get("placement_group_bundle_index", -1),
        )
        return ActorHandle(ActorID(actor_id), cls_id, self._class_name)


def _prepare_actor_class(cls):
    """Add framework methods to the user's class before export."""

    class Prepared(cls):  # type: ignore[misc,valid-type]
        def __ray_terminate__(self):
            import os
            import threading
            import time

            from ray_tpu_torch._private import global_state

            cw = global_state.get_core_worker()
            if cw is not None:
                cw.notify_actor_exiting()

            def _die():
                time.sleep(0.2)
                os._exit(0)

            threading.Thread(target=_die, daemon=True).start()

        def __ray_ping__(self):
            return "pong"

    Prepared.__name__ = cls.__name__
    Prepared.__qualname__ = getattr(cls, "__qualname__", cls.__name__)
    Prepared.__module__ = cls.__module__
    return Prepared


def exit_actor():
    """Terminate the current actor from inside one of its methods
    (reference: python/ray/actor.py:1035)."""
    import os
    import threading
    import time

    from ray_tpu_torch._private import global_state

    cw = global_state.get_core_worker()
    if cw is None or cw._actor_instance is None:
        raise RuntimeError("exit_actor() called outside an actor")
    cw.notify_actor_exiting()

    def _die():
        time.sleep(0.2)
        os._exit(0)

    threading.Thread(target=_die, daemon=True).start()
    raise SystemExit(0)
