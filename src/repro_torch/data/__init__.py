"""Data pipeline of the port."""

from repro_torch.data.pipeline import SyntheticLM

__all__ = ["SyntheticLM"]
