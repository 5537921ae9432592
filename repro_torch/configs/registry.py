"""Config registry, CNN half: ``--arch alexnet|vgg16|vgg19`` resolves here.

The transformer-zoo configs of ``repro.configs.registry`` are not ported
yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.models.cnn import (ALEXNET, VGG16, VGG19, CNNConfig,
                                    cnn_reduced)

_REGISTRY: Dict[str, Callable[[], CNNConfig]] = {
    "alexnet": lambda: ALEXNET,
    "vgg16": lambda: VGG16,
    "vgg19": lambda: VGG19,
}

CNN_ARCHS = sorted(_REGISTRY)


def get_config(name: str, **overrides) -> CNNConfig:
    cfg = _REGISTRY[name]()
    return cfg.replace(**overrides) if overrides else cfg


def reduced(cfg: CNNConfig) -> CNNConfig:
    """CPU-test size of the same config (tiny image and channel widths)."""
    return cnn_reduced(cfg)
