"""Observability (port of ``repro.obs``: the metrics logger only)."""
