"""The ``repro_torch.core.metrics`` import path of ``MetricsLogger`` (as
``repro.core.metrics``): one implementation, the observability layer's
(:class:`repro_torch.obs.metrics.MetricsLogger`), under both paths.
"""
from repro_torch.obs.metrics import MetricsLogger

__all__ = ["MetricsLogger"]
