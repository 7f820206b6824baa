"""Partition specs and block grids of the port (no device mesh)."""
