"""Collective data-plane counters, as plain integers of this process;
port of ray_tpu/collective/metrics.py.

One rank a process (the per-process `HostGroup`), so the counters are the
rank's; the in-process group of every rank (`backend="xla"`) sums its
ranks'. Each op adds one to the counter of the tier that carried it, so
a run can show which tier carried its ops:

HUB_OPS, RING_OPS, SHM_OPS: ops on the host tiers (ring counts both the
    pipelined and the unpipelined ring).
DEVICE_OPS: ops on the DEVICE tier (a torch.distributed process group).
PALLAS_OPS: ops on the PALLAS tier (the fused ring kernels).
QUANT_SAVED: wire bytes the int8 block-scaled format avoided sending
    against the exact dtype (`_qring_saved_bytes` per quantized device or
    pallas call; the host ring's socket bytes).
"""

HUB_OPS = 0
RING_OPS = 0
SHM_OPS = 0
DEVICE_OPS = 0
PALLAS_OPS = 0
QUANT_SAVED = 0

TIERS = ("hub", "ring", "shm", "device", "pallas")


def tier_counts() -> dict:
    """{tier: ops it carried in this process}."""
    return {t: globals()[f"{t.upper()}_OPS"] for t in TIERS}
