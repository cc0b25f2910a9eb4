"""The paper's vision models and the dense decoders (port of
``repro.models``)."""
