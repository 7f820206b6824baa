"""Newton-Schulz kernels for Hopper: tiled products, fused chain, oracles."""
