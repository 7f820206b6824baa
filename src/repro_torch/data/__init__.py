"""Data pipeline of the port."""

from repro_torch.data.pipeline import MemmapDataset, SyntheticLM, unigram_entropy

__all__ = ["MemmapDataset", "SyntheticLM", "unigram_entropy"]
