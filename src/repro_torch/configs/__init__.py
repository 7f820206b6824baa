"""Config registry of the port: the reference registry's ten architectures
and the paper's training models.

``ARCHS`` holds the reference registry's architectures (dense, MoE, SSM,
hybrid, VLM and audio), which the port's model, training and serving paths
run; ``PAPER_CONFIGS`` the paper's Llama-style training models.
"""

from repro_torch.configs.base import SHAPES, InputShape, ModelConfig, NSEngineConfig
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.internvl2_1b import CONFIG as _internvl2
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.minitron_8b import CONFIG as _minitron
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.muonbp_paper import PAPER_CONFIGS
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.phi4_mini_3_8b import CONFIG as _phi4
from repro_torch.configs.whisper_small import CONFIG as _whisper

ARCHS: dict[str, ModelConfig] = {
    cfg.name: cfg
    for cfg in [_granite, _mixtral, _phi4, _internvl2, _gemma2, _whisper, _hymba, _olmoe,
                _minitron, _mamba2]
}


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in PAPER_CONFIGS:
        return PAPER_CONFIGS[name]
    raise KeyError(
        f"unknown arch {name!r}; available: {sorted(ARCHS) + sorted(PAPER_CONFIGS)}"
    )


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


def shape_applies(cfg: ModelConfig, shape: InputShape) -> bool:
    """The assignment's rule: ``long_500k`` only for sub-quadratic archs."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


__all__ = ["ARCHS", "InputShape", "ModelConfig", "NSEngineConfig", "PAPER_CONFIGS", "SHAPES",
           "get_config", "get_shape", "shape_applies"]
