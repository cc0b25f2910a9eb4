"""Low-overhead host-side span tracer with Chrome/Perfetto export (a copy
of ``repro.obs.trace``'s tracer).

A :class:`Tracer` records nested wall-clock spans around the hot host-side
loops (decode step, admission, page allocation) and exports them as Chrome
trace-event JSON — a flat list of ``"ph": "X"`` complete events that
``chrome://tracing`` and https://ui.perfetto.dev load directly.

1. **Zero-cost disabled path.** ``Tracer(enabled=False).span(...)`` returns
   ONE module-level singleton no-op context manager — no allocation, no
   clock read — and :data:`NULL_TRACER` is what un-instrumented call sites
   bind.
2. **Device alignment.** With ``annotate_device=True`` each span also
   enters a ``torch.profiler.record_function`` of the same name, so a
   ``torch.profiler`` trace lines the card's kernels up under the host span
   names.
3. **Timestamps.** Spans are timed with ``perf_counter_ns`` against a
   per-tracer origin, emitted in microseconds (the trace-event unit).

:class:`device_trace` captures the card's (and the host's) activity with
``torch.profiler`` into a Chrome trace, and ``python -m repro_torch.obs
--label NAME -- cmd`` (:func:`_main`) times a command inside one span.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch


class _NullSpan:
    """The shared no-op span: enter/exit do nothing, allocate nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """One live span; records a complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._ann = None

    def __enter__(self):
        if self._tracer.annotate_device:
            self._ann = torch.profiler.record_function(self._name)
            self._ann.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        tr = self._tracer
        ev = {"name": self._name, "ph": "X", "pid": tr.pid,
              "tid": threading.get_ident(),
              "ts": (self._t0 - tr.origin_ns) / 1e3,
              "dur": (t1 - self._t0) / 1e3}
        if self._args:
            ev["args"] = self._args
        tr.events.append(ev)
        return False


class Tracer:
    """Host-side span recorder; ``enabled=False`` is the zero-cost path."""

    def __init__(self, enabled: bool = True,
                 annotate_device: bool = False):
        self.enabled = enabled
        self.annotate_device = annotate_device
        self.pid = os.getpid()
        self.origin_ns = time.perf_counter_ns()
        self.events: List[Dict[str, Any]] = []

    def span(self, name: str, **args):
        """Context manager timing one span; kwargs become event args."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker event (``"ph": "i"``)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t", "pid": self.pid,
              "tid": threading.get_ident(),
              "ts": (time.perf_counter_ns() - self.origin_ns) / 1e3}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def clear(self) -> None:
        self.events = []

    def to_chrome(self) -> List[Dict[str, Any]]:
        """The Chrome trace-event list (already loadable as-is)."""
        return list(self.events)

    def write_chrome(self, path: str) -> None:
        """Write the trace as Chrome/Perfetto-loadable JSON."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


#: The disabled tracer un-instrumented call sites bind to. Spans on it are
#: the singleton no-op; never enable it in place — make your own Tracer.
NULL_TRACER = Tracer(enabled=False)


class device_trace:
    """Context manager around a ``torch.profiler`` capture of CPU and (with
    a card) CUDA activity, written on exit as a Chrome trace
    ``device_trace_<pid>.json`` under ``logdir`` (its path in ``.path``).
    With a tracer that annotates the device (``Tracer(annotate_device=
    True)``), the spans' ``record_function`` names appear in the trace over
    the kernels launched inside them.

    Unlike the reference's ``jax.profiler`` capture, which degrades to a
    warning, this raises when the profiler cannot start (one is already
    running in this process, or the profiler itself fails): a run that asked
    for a device trace does not go on without one."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path = os.path.join(logdir, f"device_trace_{os.getpid()}.json")
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        if torch._C._autograd._profiler_enabled():
            raise RuntimeError("device_trace: a profiler is already running "
                               "in this process")
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.logdir, exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
        self._prof = prof
        return self

    def __exit__(self, *exc):
        prof, self._prof = self._prof, None
        if prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(*exc)
            prof.export_chrome_trace(self.path)
        return False


def _main() -> int:
    import argparse
    import subprocess
    ap = argparse.ArgumentParser(
        description="run a command inside one tracer span and print its "
                    "wall time")
    ap.add_argument("--label", default="cmd")
    ap.add_argument("--out", default="",
                    help="write a Chrome trace JSON for the span")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- command to run")
    args = ap.parse_args()
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command given (use: ... --label NAME -- cmd args)")
    tracer = Tracer(enabled=True)
    with tracer.span(args.label, cmd=" ".join(cmd)):
        rc = subprocess.call(cmd)
    dur_s = tracer.events[-1]["dur"] / 1e6
    print(f"[trace] {args.label}: {dur_s:.1f}s (exit {rc})", flush=True)
    if args.out:
        tracer.write_chrome(args.out)
    return rc


if __name__ == "__main__":
    raise SystemExit(_main())
