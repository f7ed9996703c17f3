"""Placement groups: gang-reserved resource bundles; the port's copy of
ray_tpu/util/placement_group.py (reference: python/ray/util/
placement_group.py:29 PlacementGroup, :147 placement_group). The GCS
places the bundles and reserves them on the raylets in two phases
(prepare, commit); tasks and actors scheduled into a bundle take its
reserved resources, and a GPU bundle's leases get exactly the cards the
bundle fixed at prepare time (CUDA_VISIBLE_DEVICES).

The port has no TPU topology: "ICI_RING" places as PACK (counted by the
GCS under `gcs.placement_topology_fallbacks_total`), and `tpu_slice=`
and `cost_model=` raise (ROADMAP.md queue A item 4).
"""

from __future__ import annotations

from ray_tpu_torch._private import global_state
from ray_tpu_torch._private.ids import PlacementGroupID

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD",
                    "ICI_RING")


class PlacementGroup:
    """Handle to a placement group (reference: util/placement_group.py:29)."""

    def __init__(self, pg_id: PlacementGroupID,
                 bundles: list[dict] | None = None):
        self.id = pg_id
        self._bundles = bundles

    def ready(self, timeout: float | None = None) -> bool:
        """Block until all bundles are reserved; False at the timeout,
        PlacementGroupInfeasibleError when the cluster cannot hold the
        group, ValueError when it was removed. timeout <= 0 probes once
        without waiting."""
        from ray_tpu_torch.exceptions import PlacementGroupInfeasibleError

        cw = global_state.require_core_worker()
        if timeout is not None and timeout <= 0:
            info = cw.get_placement_group(self.id.binary())
            if info is None:
                raise ValueError(
                    f"placement group {self.id.hex()} was removed")
        else:
            info = cw.wait_placement_group(self.id.binary(), timeout=timeout)
            if info is None:
                return False
        if info["state"] == "INFEASIBLE":
            raise PlacementGroupInfeasibleError(self.id.hex(),
                                                info.get("detail", ""))
        if info["state"] == "CREATED":
            self._bundles = info["bundles"]
            return True
        return False

    def wait(self, timeout_seconds: float = 30) -> bool:
        return self.ready(timeout=timeout_seconds)

    @property
    def bundle_specs(self) -> list[dict]:
        from ray_tpu_torch._private.common import ResourceSet

        info = global_state.require_core_worker().get_placement_group(
            self.id.binary())
        if info is None:
            return []
        return [ResourceSet.from_raw(b["resources"]).to_dict()
                for b in info["bundles"]]

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def __repr__(self):
        return f"PlacementGroup({self.id.hex()[:12]})"


def placement_group(bundles: list[dict] | None = None,
                    strategy: str = "PACK", name: str = "",
                    tpu_slice: str | None = None,
                    cost_model: str = "") -> PlacementGroup:
    """Reserve `bundles` (a list of resource dicts, e.g. [{"GPU": 1}])
    across the cluster atomically (reference: util/placement_group.py:147).
    Strategies PACK, SPREAD, STRICT_PACK, STRICT_SPREAD and ICI_RING (here
    PACK: there are no ICI coordinates to order the ranks by)."""
    if tpu_slice is not None:
        raise ValueError(
            f"tpu_slice={tpu_slice!r}: the port has no TPU slices; slice "
            "reservations and their GPU counterpart (NVLink/NUMA "
            "placement) are ROADMAP.md queue A item 4")
    if cost_model:
        raise ValueError(
            f"cost_model={cost_model!r}: ICI_RING scoring is not ported "
            "(no TPU topology; ROADMAP.md queue A item 4)")
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"Invalid strategy {strategy!r}; must be one of "
            f"{VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    for b in bundles:
        if not isinstance(b, dict) or not b:
            raise ValueError(f"invalid bundle {b!r}")
        if any(v < 0 for v in b.values()):
            raise ValueError(f"negative resource in bundle {b!r}")
    cw = global_state.require_core_worker()
    pg_id = PlacementGroupID.from_random()
    cw.create_placement_group(pg_id.binary(), bundles, strategy, name)
    return PlacementGroup(pg_id)


def remove_placement_group(pg: PlacementGroup) -> None:
    """Release all bundles; workers still leasing from them are killed
    (reference: util/placement_group.py remove_placement_group)."""
    global_state.require_core_worker().remove_placement_group(pg.id.binary())


def get_placement_group(name: str) -> PlacementGroup:
    """Look up a named placement group (reference:
    util/placement_group.py:215)."""
    info = global_state.require_core_worker().get_named_placement_group(name)
    if info is None:
        raise ValueError(f"no placement group named {name!r}")
    return PlacementGroup(PlacementGroupID(info["pg_id"]),
                          info.get("bundles"))


def placement_group_table() -> dict:
    """All placement groups keyed by hex id (reference: state.py
    placement_group_table)."""
    from ray_tpu_torch._private.common import ResourceSet

    def _bundle(b):
        b = dict(b)
        b["resources"] = ResourceSet.from_raw(b["resources"]).to_dict()
        return b

    return {
        PlacementGroupID(rec["pg_id"]).hex(): {
            "state": rec["state"],
            "name": rec.get("name", ""),
            "strategy": rec["strategy"],
            "topology_plan": rec.get("topology_plan"),
            "bundles": [_bundle(b) for b in rec["bundles"]],
        }
        for rec in global_state.require_core_worker().list_placement_groups()
    }
