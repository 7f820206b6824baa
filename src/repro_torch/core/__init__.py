"""Core of the port: MuonBP, its baselines, AdamW, and the update program."""

from repro_torch.core.adamw import adamw
from repro_torch.core.blocking import (
    BlockSpec2D,
    block_spec_from_partition,
    partition_blocks,
    unpartition_blocks,
)
from repro_torch.core.combine import apply_updates, combine, default_label_fn, label_tree
from repro_torch.core.muon import Optimizer, block_muon, muon, muon_full, phase_for_step
from repro_torch.core.newton_schulz import (
    JORDAN_COEFFS,
    PAPER_COEFFS,
    orthogonality_error,
    orthogonalize,
    orthogonalize_plain,
)
from repro_torch.core.program import LeafSpec, UpdateProgram, compile_program

__all__ = [
    "adamw",
    "apply_updates",
    "BlockSpec2D",
    "block_muon",
    "block_spec_from_partition",
    "combine",
    "compile_program",
    "default_label_fn",
    "JORDAN_COEFFS",
    "label_tree",
    "LeafSpec",
    "muon",
    "muon_full",
    "Optimizer",
    "orthogonality_error",
    "orthogonalize",
    "orthogonalize_plain",
    "PAPER_COEFFS",
    "partition_blocks",
    "phase_for_step",
    "UpdateProgram",
    "unpartition_blocks",
]
