from .core import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    PrecomputeConfig,
    SelectorConfig,
    TrainConfig,
)

__all__ = [
    "SelectorConfig",
    "CLIPTextConfig",
    "CLIPVisionConfig",
    "CLIPConfig",
    "PrecomputeConfig",
    "TrainConfig",
]
