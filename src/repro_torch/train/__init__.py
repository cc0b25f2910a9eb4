"""Training loops (port of ``repro.train``: the vision half)."""
