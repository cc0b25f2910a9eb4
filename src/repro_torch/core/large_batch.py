"""LargeBatchConfig: the paper's complete large-batch recipe as one object.

Combines (paper §7's "simple set of remedies"):
  1. momentum SGD + gradient clipping + decreasing LR regime,
  2. LR scaled with batch size (sqrt by default),
  3. ghost batch normalization (for batch-normalized models) /
     ghost gradient noise (norm-independent twin, for RMSNorm LLMs),
  4. regime adaptation: enough high-LR updates (schedule stretched by
     |B_L| / |B_S|).

``presets()`` returns the exact method column-set of Table 1:
SB, LB, LB+LR, LB+LR+GBN, LB+LR+GBN+RA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.lr_scaling import noise_sigma, scale_lr
from repro_torch.core.regime import Regime, adapt_regime


@dataclass(frozen=True)
class LargeBatchConfig:
    batch_size: int
    base_batch_size: int = 128        # the paper's |B_S|
    lr_rule: str = "sqrt"             # "sqrt" | "linear" | "none"
    ghost_batch_size: int = 128       # GBN virtual batch (|B_S| in Alg. 1)
    use_gbn: bool = True              # only effective for BN-carrying models
    regime_adaptation: bool = True
    grad_clip: float = 1.0            # global-norm clip (paper §4)
    ghost_noise: float = 0.0          # base sigma for multiplicative noise
    momentum: float = 0.9
    nesterov: bool = False

    @property
    def batch_ratio(self) -> float:
        return self.batch_size / self.base_batch_size

    def effective_lr(self, base_lr: float) -> float:
        return scale_lr(base_lr, self.batch_size, self.base_batch_size,
                        self.lr_rule)

    def effective_noise_sigma(self) -> float:
        if self.ghost_noise <= 0:
            return 0.0
        return noise_sigma(self.batch_size, self.base_batch_size,
                           self.ghost_noise)

    def build_regime(self, small_batch_regime: Regime) -> Regime:
        return adapt_regime(small_batch_regime,
                            batch_size=self.batch_size,
                            base_batch_size=self.base_batch_size,
                            lr_rule=self.lr_rule,
                            regime_adaptation=self.regime_adaptation)


def presets(large_batch: int, small_batch: int = 128,
            ghost: int = 128) -> Dict[str, LargeBatchConfig]:
    """The Table-1 method columns."""
    return {
        # small-batch reference: no scaling needed, plain BN == GBN at B_S
        "SB": LargeBatchConfig(
            batch_size=small_batch, base_batch_size=small_batch,
            lr_rule="none", use_gbn=False, regime_adaptation=False,
            ghost_batch_size=ghost, grad_clip=0.0),
        # naive large batch (the gap-exhibiting baseline)
        "LB": LargeBatchConfig(
            batch_size=large_batch, base_batch_size=small_batch,
            lr_rule="none", use_gbn=False, regime_adaptation=False,
            ghost_batch_size=ghost, grad_clip=0.0),
        "LB+LR": LargeBatchConfig(
            batch_size=large_batch, base_batch_size=small_batch,
            lr_rule="sqrt", use_gbn=False, regime_adaptation=False,
            ghost_batch_size=ghost),
        "LB+LR+GBN": LargeBatchConfig(
            batch_size=large_batch, base_batch_size=small_batch,
            lr_rule="sqrt", use_gbn=True, regime_adaptation=False,
            ghost_batch_size=ghost),
        "LB+LR+GBN+RA": LargeBatchConfig(
            batch_size=large_batch, base_batch_size=small_batch,
            lr_rule="sqrt", use_gbn=True, regime_adaptation=True,
            ghost_batch_size=ghost),
    }
