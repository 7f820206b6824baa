"""Config registry of the port: the paper's dense Llama-style models.

The other architectures of the reference registry (MoE, SSM, hybrid,
encoder-decoder, VLM) are not ported yet; asking for one raises.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.muonbp_paper import PAPER_CONFIGS


def get_config(name: str) -> ModelConfig:
    if name in PAPER_CONFIGS:
        return PAPER_CONFIGS[name]
    raise KeyError(
        f"unknown or not yet ported arch {name!r}; available: {sorted(PAPER_CONFIGS)}"
    )


__all__ = ["ModelConfig", "PAPER_CONFIGS", "get_config"]
