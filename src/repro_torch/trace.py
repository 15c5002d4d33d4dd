"""Spans of the serving path, recorded only while ``torch.profiler`` runs.

Each layer boundary of ``AnalyticsFrontend.step`` opens a span named in
:data:`SPANS` (``hsz.<layer>...``).  With no profiler running, :func:`span`
returns one shared no-op context and :func:`spanned` calls straight
through: no ``RecordFunction`` is created, and a span costs a flag read.
Under ``torch.profiler.profile`` each span is a ``cpu_op`` event on the
profiler's clock, the clock of the device's activities, nested on the
serving thread as the calls are.  The spans use ``_RecordFunctionFast``
and not ``torch.profiler.record_function``: the latter is a user
annotation, which the profiler also mirrors onto the device's timeline,
where it would read as device activity.

There is no switch of its own: run the frontend under
``torch.profiler.profile(activities=[CPU, CUDA])`` and read
``prof.events()``, or write a timeline with ``export_chrome_trace``.
"""
from __future__ import annotations

import contextlib
import functools

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

#: every span the port records, outermost layer first
SPANS = (
    "hsz.serve.step",       # AnalyticsFrontend.step, whole
    "hsz.serve.group_by",   # resolving ids, each request's group signature
    "hsz.query",            # one group's query, results handed back
    "hsz.plan",             # stage planning (plan_stages / plan_expr)
    "hsz.store",            # a group's store lookups (resident stages, seeds)
    "hsz.engine.run",       # an engine call: checks, program key, program
    "hsz.engine.build",     # building a program on a cache miss
    "hsz.engine.stack",     # stacking a batch's fields and seeds
    "hsz.op",               # one op's lowering rule (postlude, kernels)
    "hsz.op.torch",         # a torch rule where the fused rule declined
    "hsz.prelude",          # a StageContext reconstruction, first computed
    "hsz.decode",           # payload decode (full field or region)
    "hsz.kernel.launch",    # one launcher call into the CUDA library
)

_OFF = contextlib.nullcontext()
#: the span factory (tests count its calls)
_FAST = _RecordFunctionFast


def span(name: str):
    """A context that records span ``name`` while a profiler runs."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _FAST(name)


def spanned(name: str):
    """Decorate a function to run under span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _FAST(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
