"""DeviceContext — the execution context handed to every stage.

Counterpart of ``incubator_predictionio_tpu/parallel/mesh.py:MeshContext``,
cut to the surface the deploy, query, training and sharded-read paths use
(``is_primary``, ``device``, ``process_index``, ``process_count``,
``pad_to_batch_multiple``, ``allgather_obj``, ``stop``, ``create()``,
``from_conf``) and the named axes (``axis_names``, ``axis_size``,
``axis_size_or``, ``data_axis``; :class:`MeshConf` is the reference's
record, copied). Where the reference owns a ``jax.sharding.Mesh``, this
port owns one ``torch.device`` (the card the tables and the model live on)
and, in a multi-process job, one ``torch.distributed`` process group: one
device a process, so a mesh device is a process. Process ``p`` sits at the
row-major coordinates of the axes, as the reference's
``np.array(devs).reshape(sizes)`` places devices (:func:`axis_coords`):
under ``{"data": 2, "model": 2}`` processes 0 and 1 form one ``model``
line, 0 and 2 one ``data`` line. Each axis line that is neither one
process nor the whole job has its own ``torch.distributed`` subgroup,
made with ``dist.new_group`` in the same order on every process
(:meth:`DeviceContext._init_groups`); the collectives take an axis name
(``all_gather(t, axis="model")``, ``all_to_all(t, send, recv,
axis="expert")``) and, with none named, span the job. One point-to-point
exchange, ``ppermute(t, axis, shift)`` (the reference's
``jax.lax.ppermute`` along an axis line; :class:`PPermute` is its
differentiable form), carries ring attention's K/V rotation over ``seq``
and the pipeline's handoffs over ``pipe``.

A single process is ``{"data": 1}``; a launch without ``axes`` is
``{"data": N}``. The batch axis is always ``data`` (size 1 when the
request names none): the processes of a ``model`` or an ``expert`` line
hold the same batch, where the reference's mesh falls back to its first
axis.

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
import math
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
class MeshConf:
    """Serializable mesh request — stored on EngineInstance rows the way the
    reference stores ``sparkConf`` (EngineInstances.scala:44). A copy of
    the reference's record (mesh.py:96-111)."""

    axes: dict[str, int] | None = None  # e.g. {"data": 4, "model": 2}; None = all data
    distributed: bool = False

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "MeshConf":
        return MeshConf(axes=d.get("axes"), distributed=bool(d.get("distributed", False)))

    def to_dict(self) -> dict[str, Any]:
        return {"axes": self.axes, "distributed": self.distributed}


def resolve_axes(axes: Optional[dict[str, int]], n: int) -> tuple:
    """``axes`` over ``n`` processes as ``((name, size), ...)``: one axis
    may be -1 (inferred); no axes is ``{"data": n}``. The sizes must
    multiply to ``n``: a mismatch raises with the reference's texts
    (mesh.py:140-157) rather than dropping processes."""
    if not axes:
        return (("data", n),)
    names = list(axes.keys())
    sizes = [int(v) for v in axes.values()]
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(
                f"cannot infer -1 axis: {n} devices not divisible by {known}"
            )
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} need {math.prod(sizes)} devices, "
            f"have {n}"
        )
    return tuple(zip(names, sizes))


def axis_coords(axes: tuple, rank: int) -> dict[str, int]:
    """The row-major coordinates of process ``rank`` on ``axes`` (the
    reference's ``np.array(devs).reshape(sizes)``)."""
    sizes = [s for _, s in axes]
    return dict(zip((n for n, _ in axes),
                    (int(c) for c in np.unravel_index(rank, sizes))))


def axis_lines(axes: tuple, name: str) -> list[list[int]]:
    """Every line of processes along axis ``name``, each in axis order;
    the lines in row-major order of the other coordinates. Every process
    builds the same list, which is the order the subgroups are made in."""
    names = [n for n, _ in axes]
    grid = np.arange(math.prod(s for _, s in axes)).reshape(
        [s for _, s in axes])
    lines = np.moveaxis(grid, names.index(name), -1).reshape(
        -1, dict(axes)[name])
    return [[int(r) for r in line] for line in lines]


@dataclasses.dataclass(frozen=True)
class DeviceContext:
    """One device plus the process coordinates of the run. A multi-process
    context carries its ``torch.distributed`` ``backend`` and the
    subgroups of its axes; one built with ``process_count > 1`` and no
    group (a test's stub) raises at its first collective rather than
    acting as one process. ``axes`` is ``((name, size), ...)`` (a dict is
    taken too); empty means ``{"data": process_count}``."""

    device: torch.device
    process_index: int = 0
    process_count: int = 1
    backend: Optional[str] = None  # set when a process group is joined
    axes: tuple = ()
    # axis name -> this process's subgroup along it (axes whose lines are
    # neither one process nor the whole job); filled by _init_groups
    _groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    def __post_init__(self):
        axes = dict(self.axes) if self.axes else None
        object.__setattr__(self, "axes",
                           resolve_axes(axes, self.process_count))

    @property
    def is_primary(self) -> bool:
        """True on the process that owns storage writes (process 0)."""
        return self.process_index == 0

    # -- topology (reference mesh.py:175-194) ------------------------------
    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size, the reference's ``mesh.shape``."""
        return dict(self.axes)

    def axis_size(self, name: str) -> int:
        return self.shape[name]

    def axis_size_or(self, name: str, default: int = 1) -> int:
        """Axis size, or ``default`` when the mesh lacks the axis."""
        return self.shape.get(name, default)

    @property
    def data_axis(self) -> str:
        """The batch-parallel axis: ``data`` (module docstring)."""
        return "data"

    @property
    def data_size(self) -> int:
        """How many batch shards the job has: the ``data`` axis's size."""
        return self.axis_size_or("data")

    def axis_index(self, name: str) -> int:
        """This process's coordinate on axis ``name`` (0 when the mesh
        lacks it)."""
        if name not in self.shape:
            return 0
        return axis_coords(self.axes, self.process_index)[name]

    @property
    def data_index(self) -> int:
        """This process's batch shard: its ``data`` coordinate."""
        return self.axis_index("data")

    def pad_to_batch_multiple(self, n: int) -> int:
        """mesh.py:271: the smallest multiple of the data-axis size ≥ n."""
        k = self.data_size
        return ((n + k - 1) // k) * k

    # -- collectives ------------------------------------------------------
    def _group_ready(self) -> None:
        if self.process_count > 1 and self.backend is None:
            raise RuntimeError(
                f"DeviceContext: process_count is {self.process_count} but "
                "no process group was joined (build the context with "
                "DeviceContext.create(distributed=True))")

    def _init_groups(self) -> None:
        """One subgroup per line of every axis that is neither one process
        nor the whole job, made with ``dist.new_group`` by every process in
        the same order (axes in order, lines as :func:`axis_lines` gives
        them); this process keeps the one it belongs to on each axis."""
        import torch.distributed as dist

        for name, size in self.axes:
            if size in (1, self.process_count):
                continue
            for ranks in axis_lines(self.axes, name):
                g = dist.new_group(ranks)
                if self.process_index in ranks:
                    self._groups[name] = g

    def _line(self, axis: Optional[str]):
        """``(group, size)`` of the collective along ``axis``: the group
        None is the whole job (every process when ``axis`` is None or
        spans the job); an axis the mesh lacks is one process."""
        if axis is None:
            return None, self.process_count
        size = self.axis_size_or(axis)
        if size in (1, self.process_count):
            return None, size
        self._group_ready()
        group = self._groups.get(axis)
        if group is None:
            raise RuntimeError(
                f"DeviceContext: no process group for mesh axis {axis!r} "
                "(build the context with DeviceContext.create(distributed="
                "True, axes=...))")
        return group, size

    def allgather_obj(self, obj: Any, axis: Optional[str] = None) -> list[Any]:
        """All-gather a small picklable host object across processes, in
        process order (reference mesh.py:302); along ``axis`` only, in
        axis order, when one is named. Single-process: ``[obj]``."""
        group, size = self._line(axis)
        if size == 1:
            return [obj]
        self._group_ready()
        import torch.distributed as dist

        out: list[Any] = [None] * size
        if self.backend == "nccl":
            # NCCL stages the pickles on the thread's current card: name
            # this process's, whichever thread calls (the distributed
            # tier's guard runs the collective in a side thread)
            with torch.cuda.device(self.device):
                dist.all_gather_object(out, obj, group=group)
        else:
            dist.all_gather_object(out, obj, group=group)
        return out

    def _through_host(self, t: torch.Tensor) -> bool:
        """gloo with a CUDA tensor: the one place tensors cross to the host
        for a collective."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_gather(self, t: torch.Tensor,
                   axis: Optional[str] = None) -> torch.Tensor:
        """``[size, *t.shape]``: every process's ``t``, in process order
        (along ``axis``, in axis order, when one is named), on ``t``'s
        device."""
        group, size = self._line(axis)
        if size == 1:
            return t.unsqueeze(0)
        self._group_ready()
        import torch.distributed as dist

        src = t.contiguous()
        host = self._through_host(src)
        if host:
            src = src.cpu()
        out = torch.empty((size, *src.shape), dtype=src.dtype,
                          device=src.device)
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, src, group=group)
        else:
            dist.all_gather(list(out.unbind(0)), src, group=group)
        return out.to(t.device) if host else out

    def all_reduce_sum(self, t: torch.Tensor,
                       axis: Optional[str] = None) -> torch.Tensor:
        """The element-wise sum of every process's ``t`` (along ``axis``
        when one is named; a new tensor on ``t``'s device)."""
        group, size = self._line(axis)
        if size == 1:
            return t.clone()
        self._group_ready()
        import torch.distributed as dist

        host = self._through_host(t)
        out = t.cpu() if host else t.clone()
        dist.all_reduce(out, group=group)
        return out.to(t.device) if host else out

    def all_to_all(self, t: torch.Tensor, send_splits, recv_splits,
                   axis: Optional[str] = None) -> torch.Tensor:
        """Rows of ``t`` exchanged along ``axis`` (the whole job when none
        is named): the first ``send_splits[0]`` rows go to the line's first
        process, the next ``send_splits[1]`` to the second, and so on in
        axis order; the result holds ``recv_splits[j]`` rows from process
        ``j`` of the line, in that order, on ``t``'s device. The splits are
        host integers, one a process of the line, and may be uneven or 0
        (the receiver's ``recv_splits[j]`` is the sender's
        ``send_splits[i]``). One process: a copy."""
        group, size = self._line(axis)
        send, recv = [int(x) for x in send_splits], [int(x) for x in recv_splits]
        if len(send) != size or len(recv) != size or sum(send) != t.shape[0]:
            raise ValueError(
                f"all_to_all: splits {send} / {recv} for {t.shape[0]} rows "
                f"over a line of {size}")
        if size == 1:
            return t.clone()
        self._group_ready()
        import torch.distributed as dist

        src = t.contiguous()
        host = self._through_host(src)
        if host:
            src = src.cpu()
        out = torch.empty((sum(recv), *src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.all_to_all_single(out, src, recv, send, group=group)
        return out.to(t.device) if host else out

    def ppermute_peers(self, axis: str, shift: int = 1, cyclic: bool = True):
        """``(to, from)``: the global ranks this process sends to and
        receives from under :meth:`ppermute`, None where it does not."""
        size = self.axis_size_or(axis)
        me = self.axis_index(axis)
        line = next(ln for ln in axis_lines(self.axes, axis)
                    if self.process_index in ln) if size > 1 else [self.process_index]

        def at(i):
            if cyclic:
                return line[i % size]
            return line[i] if 0 <= i < size else None

        return at(me + shift), at(me - shift)

    def ppermute(self, t: torch.Tensor, axis: str, shift: int = 1,
                 cyclic: bool = True) -> torch.Tensor:
        """``jax.lax.ppermute`` along one line of ``axis``: the member at
        position ``i`` of the line sends ``t`` to the member at ``i +
        shift`` and returns what the member at ``i − shift`` sent, on
        ``t``'s device. ``cyclic`` (the ring ``[(i, (i + shift) % s)]``)
        wraps around the line; otherwise the pairs that fall off it are
        dropped, a member that receives nothing gets zeros, as ppermute's
        partial permutations give. Every member of the line calls it with a
        tensor of one shape and dtype. One point-to-point exchange a pair
        (``dist.batch_isend_irecv``: NCCL on the card, gloo through the
        host); one process (or a shift of the whole line): a copy. Its
        transpose is ``shift=-shift`` (:class:`PPermute`)."""
        size = self.axis_size_or(axis)
        to, frm = self.ppermute_peers(axis, shift, cyclic)
        if size == 1 or (cyclic and shift % size == 0):
            return t.clone()
        self._group_ready()
        import torch.distributed as dist

        src = t.contiguous()
        host = self._through_host(src)
        if host:
            src = src.cpu()
        out = torch.zeros_like(src)
        group = self._line(axis)[0]
        ops = []
        if to is not None:
            ops.append(dist.P2POp(dist.isend, src, to, group))
        if frm is not None:
            ops.append(dist.P2POp(dist.irecv, out, frm, group))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        return out.to(t.device) if host else out

    def stop(self) -> None:
        """Leave the process group (the reference's ``sc.stop()`` hook)."""
        if self.backend is not None:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()

    @staticmethod
    def create(device: Optional[Union[str, torch.device]] = None,
               distributed: bool = False,
               axes: Optional[dict[str, int]] = None) -> "DeviceContext":
        """``cuda:0`` unless the caller names another device. Raises when
        CUDA is asked for (explicitly or by default) and absent: the port
        never falls back to the CPU on its own — pass ``device="cpu"`` to
        run there, as the CPU tests do. ``distributed=True`` joins the job
        :func:`init_distributed_from_env` describes. ``axes`` names the
        mesh axes over the processes (:func:`resolve_axes`; their sizes
        must multiply to the process count)."""
        if distributed:
            rank, world, backend, dev = init_distributed_from_env(device)
            ctx = DeviceContext(dev, rank, world, backend, axes or ())
            ctx._init_groups()
            if axes:
                logger.info("mesh: %s over %d processes; process %d at %s",
                            ctx.shape, world, rank,
                            axis_coords(ctx.axes, rank))
            return ctx
        dev = torch.device("cuda:0" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"DeviceContext: {dev} requested but CUDA is not available "
                "(pass device='cpu' to run on the CPU)")
        return DeviceContext(dev, axes=axes or ())

    @staticmethod
    def from_conf(conf: "MeshConf | dict[str, Any] | None",
                  device: Optional[Union[str, torch.device]] = None
                  ) -> "DeviceContext":
        """The context a stored mesh request describes (reference
        mesh.py:164-169), on ``device``."""
        if conf is None:
            return DeviceContext.create(device)
        if isinstance(conf, dict):
            conf = MeshConf.from_dict(conf)
        return DeviceContext.create(device, distributed=conf.distributed,
                                    axes=conf.axes)


class PPermute(torch.autograd.Function):
    """:meth:`DeviceContext.ppermute` with its transpose as the backward:
    each gradient goes back the way its value came (``shift=-shift``), as
    ``jax.lax.ppermute``'s transpose does. Every member of the line runs
    the backward exchange, so every member's output must reach the loss
    (each process builds the same graph)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, shift, cyclic):
        ctx.args = (mesh, axis, shift, cyclic)
        return mesh.ppermute(t, axis, shift, cyclic)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, shift, cyclic = ctx.args
        return mesh.ppermute(g, axis, -shift, cyclic), None, None, None, None


def ppermute(mesh: DeviceContext, t: torch.Tensor, axis: str, shift: int = 1,
             cyclic: bool = True) -> torch.Tensor:
    """The differentiable form of :meth:`DeviceContext.ppermute`."""
    return PPermute.apply(t, mesh, axis, shift, cyclic)


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


def check_replicas(ctx, arrays, axis: Optional[str] = None) -> str:
    """A digest of this replica's host arrays (a data-parallel fit's
    tables or parameters), compared with every other process's (along
    ``axis`` only, when one is named: a model-axis fit's blocks have their
    replicas on its ``data`` line); raises if any differs (the primary
    persists its replica as the job's model)."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        h.update(memoryview(np.ascontiguousarray(a)).cast("B"))
    mine = h.hexdigest()
    digests = ctx.allgather_obj(mine, axis=axis)
    if len(set(digests)) != 1:
        raise RuntimeError(
            f"data-parallel fit: the replicas differ across processes "
            f"(digests {digests}); the primary's model would not be the job's")
    return mine
