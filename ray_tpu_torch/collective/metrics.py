"""Collective data-plane counters, as plain integers; port of
ray_tpu/collective/metrics.py.

The JAX package keeps one rank per process, so its counters are per
rank. Here every rank of a group lives in one process, and these
counters sum over the process's ranks.

PALLAS_OPS: ops dispatched on the PALLAS tier (one call of the transport,
    one ring kernel per rank).
QUANT_SAVED: wire bytes the int8 block-scaled format avoided sending
    against the exact dtype (`_qring_saved_bytes` per quantized call).
"""

PALLAS_OPS = 0
QUANT_SAVED = 0
