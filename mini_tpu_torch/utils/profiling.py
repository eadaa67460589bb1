"""Tracing and profiling hooks: ``torch.profiler`` in place of
``mini_tpu``'s ``jax.profiler`` traces and ``jax.named_scope``s.

``scope(name)`` marks a region in a trace only while a profiler runs.
``jax.named_scope`` costs nothing at run time (it names ops while JAX
traces); a ``record_function`` costs host time at every entry, and the
port's traversal rounds are host-bound, so without a profiler ``scope``
returns one shared context that does nothing.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile

import torch

_NO_SCOPE = contextlib.nullcontext()


@contextlib.contextmanager
def trace(dir_path: str | None = None):
    """Profile the block with ``torch.profiler`` (host and CUDA activity;
    the CUDA part only where a card is present) and write a Chrome trace,
    ``trace.json``, into ``dir_path`` (default: ``mini_tpu_trace`` in the
    temporary directory).  Yields the directory."""
    if dir_path is None:
        dir_path = os.path.join(tempfile.gettempdir(), "mini_tpu_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(dir_path, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield dir_path
    prof.export_chrome_trace(os.path.join(dir_path, "trace.json"))


def scope(name: str):
    """Named scope so operators show up in profiles:

        with scope("advance"):
            ...

    A ``torch.profiler.record_function`` while a profiler runs; otherwise
    a shared context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SCOPE


def scope_of(fmt: str, *args):
    """:func:`scope` named ``fmt.format(*args)``, the name made only while a
    profiler runs (for names that vary per use)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(fmt.format(*args))
    return _NO_SCOPE


def annotate(name: str):
    """Decorator form of :func:`scope`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with scope(name):
                return fn(*a, **k)

        return wrapped

    return deco
