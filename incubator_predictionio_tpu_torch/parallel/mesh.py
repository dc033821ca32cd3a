"""DeviceContext — the execution context handed to every stage.

Counterpart of ``incubator_predictionio_tpu/parallel/mesh.py:MeshContext``,
cut to the surface the deploy, query, training and sharded-read paths use
(``is_primary``, ``device``, ``process_index``, ``process_count``,
``pad_to_batch_multiple``, ``allgather_obj``, ``stop``, ``create()``).
Where the reference owns a ``jax.sharding.Mesh``, this port owns one
``torch.device`` (the card the tables and the model live on) and, in a
multi-process job, one ``torch.distributed`` process group: one device a
process, so the data axis is the process count.

:func:`init_distributed_from_env` joins the job the launcher
(``parallel/launcher.py``) or an operator's per-host script describes with
the reference's ``PIO_DIST_*`` variables (reference mesh.py:68-96).
:func:`pick_backend` is the one place the backend is chosen: ``nccl`` when
every process owns a card of its own (process i takes ``cuda:i``), else
``gloo`` — for CPU processes, and for processes that share one card, which
NCCL refuses. Under gloo the collectives on CUDA tensors go through
explicit host copies (:meth:`DeviceContext._through_host`), never through
gloo's partial CUDA support. :class:`CollectiveClock` times a
data-parallel fit's collectives and :func:`check_replicas` proves its
replicas equal at the end (both fits, ``models/two_tower.py`` and
``models/transformer.py``).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import hashlib
import logging
import os
import time
from typing import Any, Optional, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: how long a collective (and the rendezvous) waits for a peer before it
#: raises: a dead or wedged peer fails the job instead of hanging it
DIST_TIMEOUT_SEC = 300.0


def pick_backend(device_type: str, world_size: int) -> str:
    """``nccl`` when CUDA processes each own a card
    (``torch.cuda.device_count() >= world_size``), ``gloo`` otherwise: CPU
    processes, and CUDA processes sharing a card."""
    if device_type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_distributed_from_env(device: Optional[Union[str, torch.device]] = None,
                              timeout: float = DIST_TIMEOUT_SEC
                              ) -> tuple[int, int, str, torch.device]:
    """Join (or form) a multi-process job — the spark-submit replacement
    (reference mesh.py:68-96). The topology comes from
    ``PIO_DIST_COORDINATOR`` (host:port of the rendezvous),
    ``PIO_DIST_NUM_PROCESSES`` and ``PIO_DIST_PROCESS_ID``, set per process
    by :func:`~incubator_predictionio_tpu_torch.parallel.launcher.launch_local`.
    ``device`` is what the process asked for: None is the card, ``"cpu"``
    the CPU; under ``nccl`` process i takes ``cuda:i``. Returns (rank,
    world size, backend, device); the backend is logged."""
    import torch.distributed as dist

    coordinator = os.environ.get("PIO_DIST_COORDINATOR")
    if not coordinator:
        raise RuntimeError(
            "init_distributed_from_env: PIO_DIST_COORDINATOR is not set (run "
            "the verb under `launch`, or set PIO_DIST_COORDINATOR, "
            "PIO_DIST_NUM_PROCESSES and PIO_DIST_PROCESS_ID)")
    world = int(os.environ["PIO_DIST_NUM_PROCESSES"])
    rank = int(os.environ["PIO_DIST_PROCESS_ID"])
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"init_distributed_from_env: {dev} requested but CUDA is not "
            "available (pass device='cpu' to run on the CPU)")
    backend = pick_backend(dev.type, world)
    if backend == "nccl":
        dev = torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}", world_size=world,
            rank=rank, timeout=_dt.timedelta(seconds=timeout))
    logger.info("distributed: process %d of %d, backend %s, device %s",
                rank, world, backend, dev)
    return rank, world, backend, dev


@dataclasses.dataclass(frozen=True)
class DeviceContext:
    """One device plus the process coordinates of the run. A multi-process
    context carries its ``torch.distributed`` ``backend``; one built with
    ``process_count > 1`` and no group (a test's stub) raises at its first
    collective rather than acting as one process."""

    device: torch.device
    process_index: int = 0
    process_count: int = 1
    backend: Optional[str] = None  # set when a process group is joined

    @property
    def is_primary(self) -> bool:
        """True on the process that owns storage writes (process 0)."""
        return self.process_index == 0

    def pad_to_batch_multiple(self, n: int) -> int:
        """mesh.py:271: the smallest multiple of the data axis ≥ n. One
        device a process, so the data axis is the process count."""
        k = self.process_count
        return ((n + k - 1) // k) * k

    # -- collectives ------------------------------------------------------
    def _group_ready(self) -> None:
        if self.process_count > 1 and self.backend is None:
            raise RuntimeError(
                f"DeviceContext: process_count is {self.process_count} but "
                "no process group was joined (build the context with "
                "DeviceContext.create(distributed=True))")

    def allgather_obj(self, obj: Any) -> list[Any]:
        """All-gather a small picklable host object across processes, in
        process order (reference mesh.py:302). Single-process: ``[obj]``."""
        if self.process_count == 1:
            return [obj]
        self._group_ready()
        import torch.distributed as dist

        out: list[Any] = [None] * self.process_count
        if self.backend == "nccl":
            # NCCL stages the pickles on the thread's current card: name
            # this process's, whichever thread calls (the distributed
            # tier's guard runs the collective in a side thread)
            with torch.cuda.device(self.device):
                dist.all_gather_object(out, obj)
        else:
            dist.all_gather_object(out, obj)
        return out

    def _through_host(self, t: torch.Tensor) -> bool:
        """gloo with a CUDA tensor: the one place tensors cross to the host
        for a collective."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[process_count, *t.shape]``: every process's ``t``, in process
        order, on ``t``'s device."""
        if self.process_count == 1:
            return t.unsqueeze(0)
        self._group_ready()
        import torch.distributed as dist

        src = t.contiguous()
        host = self._through_host(src)
        if host:
            src = src.cpu()
        out = torch.empty((self.process_count, *src.shape), dtype=src.dtype,
                          device=src.device)
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, src)
        else:
            dist.all_gather(list(out.unbind(0)), src)
        return out.to(t.device) if host else out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The element-wise sum of every process's ``t`` (a new tensor on
        ``t``'s device)."""
        if self.process_count == 1:
            return t.clone()
        self._group_ready()
        import torch.distributed as dist

        host = self._through_host(t)
        out = t.cpu() if host else t.clone()
        dist.all_reduce(out)
        return out.to(t.device) if host else out

    def stop(self) -> None:
        """Leave the process group (the reference's ``sc.stop()`` hook)."""
        if self.backend is not None:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()

    @staticmethod
    def create(device: Optional[Union[str, torch.device]] = None,
               distributed: bool = False) -> "DeviceContext":
        """``cuda:0`` unless the caller names another device. Raises when
        CUDA is asked for (explicitly or by default) and absent: the port
        never falls back to the CPU on its own — pass ``device="cpu"`` to
        run there, as the CPU tests do. ``distributed=True`` joins the job
        :func:`init_distributed_from_env` describes."""
        if distributed:
            rank, world, backend, dev = init_distributed_from_env(device)
            return DeviceContext(dev, rank, world, backend)
        dev = torch.device("cuda:0" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"DeviceContext: {dev} requested but CUDA is not available "
                "(pass device='cpu' to run on the CPU)")
        return DeviceContext(dev)


class CollectiveClock:
    """The time a fit spends in its collectives: CUDA events around each
    call on the card (the device timeline from the call's start to its
    result, host copies and waits for peers included), the host clock on
    the CPU. Read once, after the fit's last sync."""

    def __init__(self, device: torch.device):
        self._cuda = torch.device(device).type == "cuda"
        self._events: list = []
        self._host = 0.0

    def time(self, fn):
        if self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            self._events.append((start, end))
            return out
        t = time.perf_counter()
        out = fn()
        self._host += time.perf_counter() - t
        return out

    def seconds(self) -> float:
        return self._host + sum(a.elapsed_time(b) for a, b in self._events) / 1e3


def check_replicas(ctx, arrays) -> str:
    """A digest of this replica's host arrays (a data-parallel fit's
    tables or parameters), compared with every other process's; raises if
    any differs (the primary persists its replica as the job's model)."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        h.update(memoryview(np.ascontiguousarray(a)).cast("B"))
    mine = h.hexdigest()
    digests = ctx.allgather_obj(mine)
    if len(set(digests)) != 1:
        raise RuntimeError(
            f"data-parallel fit: the replicas differ across processes "
            f"(digests {digests}); the primary's model would not be the job's")
    return mine
