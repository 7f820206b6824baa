"""Hand-written Hopper kernels of the port and their dispatch.

``kernel_wrappers`` names every kernel wrapper; ``launch_counts`` and
``reset_launch_counts`` read and zero their launch counters.
"""

from __future__ import annotations


def kernel_wrappers() -> dict:
    """``{name: wrapper}`` for every ported kernel (each has ``.launches``)."""
    from repro_torch.kernels.newton_schulz import fused
    from repro_torch.kernels.newton_schulz import newton_schulz as tiled

    return {
        "ns_matmul": tiled.matmul,
        "ns_fma_matmul": tiled.fma_matmul,
        "ns_fused_chain": fused.ns_chain,
        "ns_fused_iter": fused.ns_iteration,
    }


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
