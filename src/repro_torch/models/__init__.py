"""The paper's vision models (port of ``repro.models`` mlp/cnn)."""
