"""Training loops (port of ``repro.train``: the vision and LM trainers)."""
