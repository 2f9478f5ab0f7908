from repro_torch.kernels.segment_agg.ops import (
    LAUNCHES,
    LeveledPlan,
    SegmentPlan,
    make_leveled_plan,
    make_plan,
    reset_launches,
    segment_agg,
    segment_agg_active_stacked,
    segment_agg_level,
    segment_agg_level_stacked,
)
from repro_torch.kernels.segment_agg.ref import (
    segment_agg_level_ref,
    segment_agg_ref,
)

__all__ = [
    "LAUNCHES",
    "LeveledPlan",
    "SegmentPlan",
    "make_leveled_plan",
    "make_plan",
    "reset_launches",
    "segment_agg",
    "segment_agg_active_stacked",
    "segment_agg_level",
    "segment_agg_level_stacked",
    "segment_agg_level_ref",
    "segment_agg_ref",
]
