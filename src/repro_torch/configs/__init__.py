"""The paper's vision model configurations (copied from ``repro.configs``)."""
from repro_torch.configs.paper_models import (C1_CIFAR10, C3_CIFAR100,
                                              F1_MNIST, PAPER_MODELS,
                                              RESNET44_CIFAR10,
                                              WRESNET16_CIFAR100,
                                              VisionModelConfig)

__all__ = ["C1_CIFAR10", "C3_CIFAR100", "F1_MNIST", "PAPER_MODELS",
           "RESNET44_CIFAR10", "WRESNET16_CIFAR100", "VisionModelConfig"]
