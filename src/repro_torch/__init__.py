"""PyTorch/CUDA port of the MuonBP system for NVIDIA Hopper.

Mirrors the JAX package ``repro`` subpackage for subpackage: every module
here has one counterpart there, which is its numerical reference. The port
imports ``torch`` only. Parameters keep the reference's stacked ``(L, ...)``
layout under the same path names, so a reference parameter pytree carries
over leaf for leaf (``repro_torch.interop``) and the optimizer's shape
buckets come out identical.

Entry points default to ``device="cuda"`` and raise on a machine without a
card; tests pass ``device="cpu"``, where every kernel wrapper runs its plain
PyTorch version.
"""
