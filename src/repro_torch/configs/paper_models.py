"""The paper's own experimental models (Table 1 / Table 2).

These are the vision/MLP models on which the generalization-gap experiments
run — they carry Batch Normalization, so they are the models that exercise
Ghost Batch Normalization end-to-end. Per the "implement the baseline too"
rule, we implement the representative set: F1 (MNIST MLP), C1/C3 (shallow
convnets), and a ResNet44-style residual CNN. All are built from
``repro_torch.models.mlp`` / ``repro_torch.models.cnn``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class VisionModelConfig:
    name: str
    kind: str                       # "mlp" | "convnet" | "resnet"
    input_shape: Tuple[int, int, int]   # (H, W, C)
    n_classes: int
    # mlp
    hidden_sizes: Tuple[int, ...] = ()
    # convnet / resnet
    channels: Tuple[int, ...] = ()
    blocks_per_stage: int = 0       # resnet: n per stage (44 = 3*2*7 + 2)
    norm: str = "gbn"               # "gbn" | "batchnorm" | "none"
    ghost_batch_size: int = 128
    bn_momentum: float = 0.1
    citation: str = ""


# F1 (Keskar et al. 2017): fully-connected MNIST net.
F1_MNIST = VisionModelConfig(
    name="f1-mnist",
    kind="mlp",
    input_shape=(28, 28, 1),
    n_classes=10,
    hidden_sizes=(512, 512, 512, 512),
    citation="Keskar et al. 2017 (F1); Hoffer et al. 2017 Table 1",
)

# C1 (Keskar et al. 2017): shallow convnet for CIFAR-10.
C1_CIFAR10 = VisionModelConfig(
    name="c1-cifar10",
    kind="convnet",
    input_shape=(32, 32, 3),
    n_classes=10,
    channels=(64, 128, 256),
    citation="Keskar et al. 2017 (C1); Hoffer et al. 2017 Table 1",
)

# C3 (Keskar et al. 2017): deeper convnet for CIFAR-100.
C3_CIFAR100 = VisionModelConfig(
    name="c3-cifar100",
    kind="convnet",
    input_shape=(32, 32, 3),
    n_classes=100,
    channels=(64, 128, 256, 512),
    citation="Keskar et al. 2017 (C3); Hoffer et al. 2017 Table 1",
)

# ResNet44 (He et al. 2016) — the paper's main topology.
RESNET44_CIFAR10 = VisionModelConfig(
    name="resnet44-cifar10",
    kind="resnet",
    input_shape=(32, 32, 3),
    n_classes=10,
    channels=(16, 32, 64),
    blocks_per_stage=7,            # 6*7 + 2 = 44 layers
    citation="He et al. 2016; Hoffer et al. 2017 Table 1",
)

# WResnet16-4 style (Zagoruyko 2016) for CIFAR-100.
WRESNET16_CIFAR100 = VisionModelConfig(
    name="wresnet16-4-cifar100",
    kind="resnet",
    input_shape=(32, 32, 3),
    n_classes=100,
    channels=(64, 128, 256),
    blocks_per_stage=2,            # 6*2 + 4 ~ 16 layers, 4x width
    citation="Zagoruyko 2016; Hoffer et al. 2017 Table 1",
)

PAPER_MODELS = {
    m.name: m
    for m in (F1_MNIST, C1_CIFAR10, C3_CIFAR100, RESNET44_CIFAR10,
              WRESNET16_CIFAR100)
}
