"""Model configurations (copies of ``repro.configs``): the paper's vision
models and the decoder models of the serving path."""
from repro_torch.configs.base import LayerSpec, ModelConfig, NormConfig
from repro_torch.configs.paper_models import (C1_CIFAR10, C3_CIFAR100,
                                              F1_MNIST, PAPER_MODELS,
                                              RESNET44_CIFAR10,
                                              WRESNET16_CIFAR100,
                                              VisionModelConfig)
from repro_torch.configs.registry import get_config, list_configs

__all__ = ["C1_CIFAR10", "C3_CIFAR100", "F1_MNIST", "LayerSpec",
           "ModelConfig", "NormConfig", "PAPER_MODELS", "RESNET44_CIFAR10",
           "WRESNET16_CIFAR100", "VisionModelConfig", "get_config",
           "list_configs"]
