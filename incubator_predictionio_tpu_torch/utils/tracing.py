"""Profiling hooks on ``torch.profiler``.

Counterpart of ``incubator_predictionio_tpu/utils/tracing.py``, whose
hooks are ``jax.profiler``'s; the same four names here:

- :func:`profile_trace`: capture a profiler trace of any block (a training
  run, a burst of served batches) into a log dir that TensorBoard's
  PyTorch profiler plugin (or ``chrome://tracing``) reads; exposed as
  ``train --profile-dir DIR``;
- :func:`annotate` / :func:`step_annotation`: named host-side ranges that
  show up on the trace's timeline (wrap one epoch chunk, one batch);
- :func:`device_memory_report`: per-device allocator bytes in use, peak and
  the card's total, printed by ``status`` and folded into the
  ``pio_device_bytes_*`` gauges.

:func:`device_memory_report` never starts CUDA: where
``torch.cuda.is_initialized()`` is False (a CPU process, the tests, a
server that never touched a card) it gives the reference's CPU answer, and
otherwise it reports only the cards on which this process already holds a
context, since a query on any other card would create one (about 500 MB
of device memory, in every process that asks).
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` (``tensorboard_trace_handler``: one ``*.pt.trace.json`` a
    process). CPU activity always; CUDA activity (every kernel and copy,
    CUPTI) when a card is in use. :func:`annotate` ranges opened inside
    the block appear on its timeline."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """Named range context manager visible on the profiler timeline."""
    return torch.profiler.record_function(name)


def step_annotation(name: str, step: Optional[int] = None):
    """A range carrying a step number (``name#step``), as the reference's
    ``StepTraceAnnotation`` groups per-step stats."""
    return torch.profiler.record_function(
        name if step is None else f"{name}#{step}")


def _initialized_cards() -> list[int]:
    """Indices of the cards on which this process holds a CUDA context;
    [] where CUDA was never initialized in this process."""
    if not torch.cuda.is_initialized():
        return []
    return [d for d in range(torch.cuda.device_count())
            if torch._C._cuda_hasPrimaryContext(d)]


def device_memory_report() -> list[dict[str, Any]]:
    """One row per local device with the reference's keys: the allocator's
    ``bytes_in_use`` (``memory_allocated``) and ``peak_bytes_in_use``
    (``max_memory_allocated``), and ``bytes_limit``, the card's total from
    ``mem_get_info``. Where no card is initialized in this process: the
    reference's CPU answer, one ``cpu`` row of ``None`` stats."""
    cards = _initialized_cards()
    if not cards:
        return [{"device": "cpu", "platform": "cpu", "bytes_in_use": None,
                 "bytes_limit": None, "peak_bytes_in_use": None}]
    rows: list[dict[str, Any]] = []
    for d in cards:
        _, total = torch.cuda.mem_get_info(d)
        rows.append({
            "device": f"cuda:{d}",
            "platform": "gpu",
            "bytes_in_use": torch.cuda.memory_allocated(d),
            "bytes_limit": total,
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(d),
        })
    return rows
