"""Config registry of the port: the dense architectures.

``ARCHS`` holds the reference registry's dense architectures, which the
port's model and serving path run; ``PAPER_CONFIGS`` the paper's Llama-style
training models. The reference registry's other architectures (MoE, SSM,
hybrid, encoder-decoder, VLM) are not ported yet; asking for one raises.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.minitron_8b import CONFIG as _minitron
from repro_torch.configs.muonbp_paper import PAPER_CONFIGS
from repro_torch.configs.phi4_mini_3_8b import CONFIG as _phi4

ARCHS: dict[str, ModelConfig] = {cfg.name: cfg for cfg in [_granite, _phi4, _gemma2, _minitron]}


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in PAPER_CONFIGS:
        return PAPER_CONFIGS[name]
    raise KeyError(
        f"unknown or not yet ported arch {name!r}; available: "
        f"{sorted(ARCHS) + sorted(PAPER_CONFIGS)}"
    )


__all__ = ["ARCHS", "ModelConfig", "PAPER_CONFIGS", "get_config"]
