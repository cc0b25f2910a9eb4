"""The paper's large-batch toolkit (port of ``repro.core``)."""
from repro_torch.core.large_batch import LargeBatchConfig, presets
from repro_torch.core.regime import (BatchSchedule, Regime, adapt_regime,
                                     batch_size_increase, epochs_to_steps)

__all__ = ["BatchSchedule", "LargeBatchConfig", "Regime", "adapt_regime",
           "batch_size_increase", "epochs_to_steps", "presets"]
