"""Named ranges at the program's layer boundaries, on the profiler's clock.

:func:`span` opens a ``torch.profiler.record_function`` range while a torch
profiler is recording (``torch.profiler.profile`` around the program, e.g.
``python -m mpinets_torch.bench --profile DIR``), so the range lands in the
same trace as the device's kernels; otherwise it returns one shared no-op
context and records nothing. The profiler holds the ranges and writes them
out (``export_chrome_trace``, ``prof.events()``); nothing is kept here.

Names: ``rollout.policy`` and ``rollout.env`` (one rollout step's model call
and environment update, ``rollout/engine.py``), ``policy.tail`` (the dense
back half of the kernel forward, ``model/fused.py``), ``train.batch`` and
``train.step`` (``data/synthetic.py::training_batch``,
``train/learner.py::make_train_step``), and ``wait.h2d.<site>`` around each
copy from host memory to a card, which makes the host wait for the card's
queue to drain (:func:`h2d_wait`). No name starts with ``cu`` (a profile's
runtime calls) or ``bench.`` (the benchmark's own ranges).
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """``record_function(name)`` while a torch profiler records, else a
    shared no-op context."""
    return record_function(name) if _recording() else _OFF


def h2d_wait(site: str, device):
    """The span ``wait.h2d.<site>`` around a copy from host memory to
    ``device``; a no-op context where ``device`` is not a CUDA device (on
    the CPU nothing waits)."""
    if not _recording() or device is None or torch.device(device).type != "cuda":
        return _OFF
    return record_function("wait.h2d." + site)
