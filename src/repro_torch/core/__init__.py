"""The paper's large-batch toolkit (port of ``repro.core``)."""
from repro_torch.core.large_batch import LargeBatchConfig, presets
from repro_torch.core.regime import Regime, adapt_regime, epochs_to_steps

__all__ = ["LargeBatchConfig", "Regime", "adapt_regime", "epochs_to_steps",
           "presets"]
