from .core import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    PrecomputeConfig,
    SelectorConfig,
)

__all__ = [
    "SelectorConfig",
    "CLIPTextConfig",
    "CLIPVisionConfig",
    "CLIPConfig",
    "PrecomputeConfig",
]
