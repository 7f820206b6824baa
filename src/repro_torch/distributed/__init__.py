"""Distributed MuonBP on ``torch.distributed``: the communication plan, the
explicit engine with zero-collective block steps, ZeRO-1 state sharding,
the collective trace (counterpart of ``repro/distributed``) and the
tensor-parallel model's collectives (``tensor_parallel``)."""

from repro_torch.distributed.audit import (
    CollectiveEvent,
    Collectives,
    CollectiveTrace,
    assert_matches_plan,
    assert_matches_plan_by_axes,
    assert_pipelined_matches_plan,
    assert_staggered_matches_plan,
    bytes_by_axes,
    bytes_by_link,
)
from repro_torch.distributed.engine import ShardMapEngine, make_engine
from repro_torch.distributed.plan import (
    DCN_AXES,
    LINKS,
    MODELED_LINK_BYTES_PER_S,
    Collective,
    CommPlan,
    LeafCommPlan,
    assign_stagger_offsets,
    dion_bytes,
    layer_shard_collectives,
    layer_shard_dims,
    link_class,
    ns_chain_flops,
    overlappable_ns_bytes,
    plan_comm,
    tp_bytes,
)

__all__ = [
    "assert_matches_plan",
    "assert_matches_plan_by_axes",
    "assert_pipelined_matches_plan",
    "assert_staggered_matches_plan",
    "assign_stagger_offsets",
    "bytes_by_axes",
    "bytes_by_link",
    "Collective",
    "CollectiveEvent",
    "Collectives",
    "CollectiveTrace",
    "CommPlan",
    "DCN_AXES",
    "dion_bytes",
    "layer_shard_collectives",
    "layer_shard_dims",
    "LeafCommPlan",
    "link_class",
    "LINKS",
    "make_engine",
    "MODELED_LINK_BYTES_PER_S",
    "ns_chain_flops",
    "overlappable_ns_bytes",
    "plan_comm",
    "ShardMapEngine",
    "tp_bytes",
]
