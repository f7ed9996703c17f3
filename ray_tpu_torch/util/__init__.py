"""ray_tpu_torch.util — distributed utilities layered on the task/actor
API (reference: ray_tpu/util/__init__.py). Of the reference's, the
placement groups are ported; ActorPool and Queue are not (ROADMAP.md
queue A item 4)."""

from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    get_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)

__all__ = [
    "PlacementGroup",
    "get_placement_group",
    "placement_group",
    "placement_group_table",
    "remove_placement_group",
]
