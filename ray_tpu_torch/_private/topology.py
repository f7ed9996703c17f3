"""The (data, fsdp) mesh-shape table; copy of
ray_tpu/_private/topology.py:247-274 (MESH_SHAPES, mesh_shape_for), the
only part of the reference's topology module the port needs yet: its TPU
slice topology, cost models and ICI_RING placement are ROADMAP.md queue A
item 4.2. Free of torch, as the reference's is free of jax, so that a
control-plane process can share the table."""

from __future__ import annotations

# Rationale (SNIPPETS [2]): fsdp=4 saturates the fastest ICI links (4
# chips per tray share them), data scales linearly with pod size; tiny
# slices stay pure-DP.
MESH_SHAPES: dict[int, tuple[int, int]] = {
    1: (1, 1),
    2: (2, 1),
    4: (4, 1),
    8: (8, 1),       # v5p-8: pure DP
    16: (8, 2),
    32: (8, 4),
    64: (16, 4),
    128: (32, 4),
    256: (64, 4),
    512: (128, 4),
    768: (192, 4),
}


def mesh_shape_for(num_devices: int) -> tuple[int, int]:
    """(data, fsdp) mesh shape for `num_devices` devices. Table sizes
    resolve directly; other counts synthesize per the same rationale —
    fsdp is the largest power-of-two divisor up to 4 (the ICI-saturating
    tray width), data fills the rest. Always satisfies
    data * fsdp == num_devices."""
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    shape = MESH_SHAPES.get(num_devices)
    if shape is not None:
        return shape
    fsdp = 4 if num_devices % 4 == 0 else (2 if num_devices % 2 == 0 else 1)
    return (num_devices // fsdp, fsdp)
