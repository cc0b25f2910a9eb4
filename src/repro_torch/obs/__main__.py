"""``python -m repro_torch.obs`` — the span-wrapper CLI (see
:func:`repro_torch.obs.trace._main`). Running the package instead of the
``repro_torch.obs.trace`` submodule avoids runpy's found-in-sys.modules
warning (the package ``__init__`` imports the submodule).
"""
from repro_torch.obs.trace import _main

if __name__ == "__main__":
    raise SystemExit(_main())
