"""Process-global singletons (the analog of python/ray/worker.py's global
`Worker` object, reference: worker.py:80)."""

from __future__ import annotations

_core_worker = None


def get_core_worker():
    return _core_worker


def set_core_worker(cw) -> None:
    global _core_worker
    _core_worker = cw


def require_core_worker():
    if _core_worker is None:
        raise RuntimeError(
            "ray_tpu_torch has not been initialized; call ray_tpu_torch.init() first")
    return _core_worker
