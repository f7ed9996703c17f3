"""RemoteFunction — the `@ray_tpu_torch.remote` wrapper for plain functions
(reference: python/ray/remote_function.py:27, _remote :169)."""

from __future__ import annotations

import cloudpickle

from ray_tpu_torch._private import global_state
from ray_tpu_torch._private.common import check_num_gpus


class RemoteFunction:
    def __init__(self, fn, *, num_returns=1, num_cpus=None, num_gpus=None,
                 resources=None, max_retries=None):
        self._function = fn
        self._name = getattr(fn, "__qualname__", str(fn))
        self._num_returns = num_returns
        self._num_cpus = num_cpus
        self._num_gpus = check_num_gpus(num_gpus)
        self._resources = resources or {}
        self._max_retries = max_retries
        self._pickled = None
        self._fn_id = None
        # cached static spec prefix for the default-options hot path,
        # rebuilt if the core worker changed (re-init) — see
        # CoreWorker.make_task_template
        self._template = None
        self._template_cw = None
        self.__doc__ = fn.__doc__

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._name} cannot be called directly; use "
            f"{self._name}.remote()."
        )

    def __getstate__(self):
        # A RemoteFunction can travel inside task args / actor state; the
        # cached spec template holds this process's CoreWorker (sockets,
        # threads) and must never be pickled with it.
        state = self.__dict__.copy()
        state["_template"] = None
        state["_template_cw"] = None
        return state

    def options(self, **opts):
        parent = self

        class _Wrapped:
            def remote(self, *args, **kwargs):
                return parent._remote(args, kwargs, opts)

        return _Wrapped()

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, {})

    def _resources_dict(self, opts) -> dict:
        resources = dict(self._resources)
        resources.update(opts.get("resources") or {})
        num_cpus = opts.get("num_cpus", self._num_cpus)
        num_gpus = check_num_gpus(opts.get("num_gpus", self._num_gpus))
        resources["CPU"] = 1 if num_cpus is None else num_cpus
        if num_gpus:
            resources["GPU"] = num_gpus
        return resources

    def _remote(self, args, kwargs, opts):
        cw = global_state.require_core_worker()
        if self._fn_id is None:
            self._pickled = cloudpickle.dumps(self._function)
        fn_id = cw.export_function(self._pickled)
        self._fn_id = fn_id
        if not opts:
            # hot path: the whole static spec prefix (descriptor, owner,
            # quantized resources) is built once per (function, worker)
            # and submit pays one dict copy per call
            if self._template is None or self._template_cw is not cw:
                self._template = cw.make_task_template(
                    fn_id=fn_id,
                    name=self._name,
                    num_returns=self._num_returns,
                    resources=self._resources_dict(opts),
                    max_retries=self._max_retries,
                )
                self._template_cw = cw
            refs = cw.submit_task(args=args, kwargs=kwargs,
                                  template=self._template)
            if self._num_returns == 1:
                return refs[0]
            return refs
        num_returns = opts.get("num_returns", self._num_returns)
        pg = opts.get("placement_group")
        refs = cw.submit_task(
            fn_id=fn_id,
            name=opts.get("name", self._name),
            args=args,
            kwargs=kwargs,
            num_returns=num_returns,
            resources=self._resources_dict(opts),
            max_retries=opts.get("max_retries", self._max_retries),
            placement_group=pg.id.binary() if pg is not None else None,
            bundle_index=opts.get("placement_group_bundle_index", -1),
        )
        if num_returns == 1:
            return refs[0]
        return refs
