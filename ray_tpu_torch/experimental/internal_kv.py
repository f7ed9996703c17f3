"""GCS-backed internal KV; port of ray_tpu/experimental/internal_kv.py
(reference: python/ray/experimental/internal_kv.py) — used by libraries
(collective rendezvous, the process groups of parallel/multihost) for
small control-plane state. The reference's `_kv_exists` and `_kv_list`
have no caller in the port."""

from __future__ import annotations

from ray_tpu_torch._private import global_state


def _kv_put(key: str, value: bytes, overwrite: bool = True) -> bool:
    return global_state.require_core_worker().kv_put(key, value, overwrite)


def _kv_get(key: str) -> bytes | None:
    return global_state.require_core_worker().kv_get(key)


def _kv_del(key: str) -> bool:
    return global_state.require_core_worker().kv_del(key)
