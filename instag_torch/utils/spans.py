"""Named spans at the port's layer boundaries, for ``torch.profiler``.

``with span("render.face"): ...`` marks a layer's work on the profiler's
timeline (``torch.profiler.record_function``), on the same clock and in
the same event stream as the device trace, so a reader of the trace can
give each launch, blocking call and device operation to the layer that
made it. ``@spanned(name)`` marks a whole function.

A span is on only while a ``torch.profiler`` records. Otherwise ``span``
returns one shared no-op context (no allocation, no torch operation, no
clock read). Whoever runs the profiler keeps or exports the spans (its
``export_chrome_trace``, or the benchmark's trace reader).

Every name comes from ``NAMES``. The unit spans (``UNITS``) enclose one
synthesis frame or one training step; a unit's other spans are the ones
inside it, on its thread or on autograd's backward threads, so no
identifier is passed through the program.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import _profiler_enabled

UNITS = ("synth.frame", "train.step")
NAMES = UNITS + (
    "render.face", "render.mouth", "render.fuse", "render.move_feature",
    "render.sh", "motion.umf", "motion.pmf", "hashgrid.encode",
    "rasterize.project", "rasterize.select", "composite.fwd",
    "composite.bwd", "scatter.add", "train.forward", "train.backward",
    "optim.gaussians", "optim.nets")
_KNOWN = frozenset(NAMES)
_OFF = contextlib.nullcontext()


def _check(name: str) -> None:
    if name not in _KNOWN:
        raise ValueError(f"span {name!r} is not in utils.spans.NAMES")


def span(name: str):
    """A context that records ``name`` while a profiler records."""
    _check(name)
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: the whole call inside ``span(name)``."""
    _check(name)

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap
