"""Spans and counters the benchmark records around the program's calls.

``wraps/<span>.json`` names the functions of the program a span wraps
(module and attribute, as the caller looks them up). The wrappers are
installed for the whole run; what they record depends on the phase:

- always: the first batch solve of a kept call (its inputs and result), and
  the iterations of every batch solve that no other wrapped call encloses
  (the main solve of a replan or a cycle);
- in a traced run's window: each span's time, by CUDA events around the
  calls that no other wrapped call encloses (self time of the layer: a
  solve inside the repair ladder is the ladder's time);
- in the profiled calls after the window: a ``record_function`` range per
  span (to name the device's idle gaps) and every solve's lanes, shapes and
  iterations (the megakernel's work).

A wrapped name the program no longer has is reported, and its span reads
as missing."""

from __future__ import annotations

import contextlib
import importlib
import json
import pathlib
from collections import defaultdict

import torch

from .compare import SolveCall

WRAPS = pathlib.Path(__file__).resolve().parent / "wraps"


class Recorder:
    def __init__(self):
        self.timing = False       # span times (a traced run's window)
        self.profiling = False    # record_function ranges, launch counts
        self.keep = False         # keep the next main solve
        self.kept = None          # SolveCall of the kept call's main solve
        self.depth = 0
        self.events = defaultdict(list)
        self.main_iters = []
        self.launches = []
        self.missing = []
        self.spans = []
        self._undo = []

    # -- installation -------------------------------------------------------

    def install(self):
        for path in sorted(WRAPS.glob("*.json")):
            with open(path) as f:
                spec = json.load(f)
            span = spec["span"]
            self.spans.append(span)
            for mod_name, attr in spec["wrap"]:
                try:
                    mod = importlib.import_module(mod_name)
                    orig = getattr(mod, attr)
                except (ImportError, AttributeError):
                    self.missing.append((span, f"{mod_name}.{attr}"))
                    continue
                setattr(mod, attr, self._wrapper(orig, span))
                self._undo.append((mod, attr, orig))
        return self

    def uninstall(self):
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()

    def missing_spans(self):
        return {s for s, _ in self.missing}

    # -- recording ------------------------------------------------------------

    def _wrapper(self, orig, span):
        def wrapped(*args, **kwargs):
            outer = self.depth == 0
            ev = None
            if outer and self.timing:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            ctx = (torch.profiler.record_function(span) if self.profiling
                   else contextlib.nullcontext())
            self.depth += 1
            try:
                with ctx:
                    out = orig(*args, **kwargs)
            finally:
                self.depth -= 1
            if ev is not None:
                ev[1].record()
                self.events[span].append(ev)
            if span == "solve":
                self._on_solve(args, kwargs, out, outer)
            return out

        wrapped.__wrapped__ = orig
        return wrapped

    def _on_solve(self, args, kwargs, res, outer):
        goals, starts, cons = args[:3]
        if outer:
            self.main_iters.append(res.iters)
            if self.keep and self.kept is None:
                self.kept = SolveCall(goals=goals, starts=starts, cons=cons,
                                      warm=kwargs.get("warm_start"), res=res)
        if self.profiling:
            self.launches.append(dict(
                lanes=int(goals.shape[0]), N=int(goals.shape[1]),
                KC=int(cons.corridor_planes.shape[-2]),
                S=int(max(cons.left_planes.shape[-2],
                          cons.right_planes.shape[-2])),
                D=int(args[3].num_of_disc), itemsize=goals.element_size(),
                iters=res.iters))

    @contextlib.contextmanager
    def call(self, name):
        """One call of the traffic (a replan, a cycle)."""
        ctx = (torch.profiler.record_function(name) if self.profiling
               else contextlib.nullcontext())
        with ctx:
            yield

    # -- readings -------------------------------------------------------------

    def span_seconds(self):
        """{span: seconds summed over the window's calls} (after a
        synchronise)."""
        return {s: sum(a.elapsed_time(b) for a, b in evs) / 1e3
                for s, evs in self.events.items()}

    def reset_window(self):
        self.events.clear()
        self.main_iters.clear()
