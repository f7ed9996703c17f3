"""Zero-copy large request/response bodies; port of
ray_tpu/serve/payload.py.

Bodies over a backend's `large_payload_threshold` do NOT travel through
the router pickled inside the query: the producer (HTTP proxy for
requests, replica for responses) `put`s the raw bytes into the object
store (`_private/memstore.IN_PLASMA` entries) and ships a `LargePayload`
marker instead. The router then moves ~100 bytes of marker; the consumer
resolves the ref from the node's shared store, exactly once. A
replica-group leader forwards the MARKER to its shard members, so an
N-shard fan-out is N reads of the same stored object, not N pickled
copies.

Failure domain: the stored object is owned by the producer process; if
it dies before the consumer resolves, `unwrap` surfaces the typed
ObjectLostError (HTTP: 503)."""

from __future__ import annotations

from ray_tpu_torch.serve.metrics import M_ZERO_COPY_BYTES_TOTAL


class LargePayload:
    """Marker carrying a stored ObjectRef in place of a large body."""

    __slots__ = ("ref", "nbytes")

    def __init__(self, ref, nbytes: int):
        self.ref = ref
        self.nbytes = nbytes

    def __repr__(self):
        return f"LargePayload({self.ref!r}, {self.nbytes}B)"


def wrap(body, threshold: int | None):
    """Promote `body` to a store-backed LargePayload when it is a bytes
    blob at or over `threshold` (None/0 = never). Anything else passes
    through unchanged."""
    if not threshold:
        return body
    if isinstance(body, (bytes, bytearray, memoryview)):
        nbytes = len(body)
    else:
        nbytes = getattr(body, "nbytes", None)  # numpy arrays
        if nbytes is None:
            return body
    if nbytes < threshold:
        return body
    import ray_tpu_torch

    ref = ray_tpu_torch.put(bytes(body) if isinstance(
        body, (bytearray, memoryview)) else body)
    M_ZERO_COPY_BYTES_TOTAL.inc(nbytes)
    return LargePayload(ref, nbytes)


def unwrap(data, timeout: float = 30.0):
    """Resolve a LargePayload back to its bytes (a read of the node's
    store). Typed ObjectLostError if
    the producer died with the only copy."""
    if isinstance(data, LargePayload):
        import ray_tpu_torch

        return ray_tpu_torch.get(data.ref, timeout=timeout)
    return data
