"""Core of the port: MuonBP, its baselines and variants, AdamW, and the update program."""

from repro_torch.core.adamw import adamw
from repro_torch.core.blocking import (
    BlockSpec2D,
    block_spec_from_partition,
    partition_blocks,
    unpartition_blocks,
)
from repro_torch.core.combine import apply_updates, combine, default_label_fn, label_tree
from repro_torch.core.dion import DionState, dion
from repro_torch.core.muon import (
    Optimizer,
    StaggerSchedule,
    block_muon,
    muon,
    muon_full,
    phase_for_step,
)
from repro_torch.core.newton_schulz import (
    JORDAN_COEFFS,
    PAPER_COEFFS,
    orthogonality_error,
    orthogonalize,
    orthogonalize_plain,
    spectral_norm_est,
)
from repro_torch.core.program import LeafSpec, UpdateProgram, compile_program
from repro_torch.core.variants import VARIANTS, VariantSpec, build_variant
from repro_torch.core.variants import get as get_variant
from repro_torch.core.variants import names as variant_names

__all__ = [
    "adamw",
    "apply_updates",
    "block_muon",
    "block_spec_from_partition",
    "BlockSpec2D",
    "build_variant",
    "combine",
    "compile_program",
    "default_label_fn",
    "dion",
    "DionState",
    "get_variant",
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
    "spectral_norm_est",
    "StaggerSchedule",
    "unpartition_blocks",
    "UpdateProgram",
    "variant_names",
    "VARIANTS",
    "VariantSpec",
]
