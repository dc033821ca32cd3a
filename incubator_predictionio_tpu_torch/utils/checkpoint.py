"""Mid-training checkpoint/resume on one process.

Counterpart of ``incubator_predictionio_tpu/utils/checkpoint.py`` (:39-242):
:class:`TrainCheckpointer` (``save``, ``latest_step``, ``all_steps``,
``delete_all``, ``restore``, ``close``, the context manager, ``max_to_keep``
retention), :func:`scalar`, :func:`maybe_resume` and
:func:`checkpointed_epochs`, the epoch driver both trainers run. The
reference writes orbax checkpoints; the port writes one ``torch.save`` file
a step, ``step-<n>.pt``, atomically (``utils/fs.atomic_write_with``: a
temporary file, fsync, rename, directory fsync), so a step ``save``
returned for is restorable after a kill at any point.

A state is a tree of dicts, lists, tuples and dataclasses (the adam
states of ``utils/optim.py``) over tensors and Python ints. Dataclass
fields whose metadata says ``checkpoint=False`` (adam's kept scratch
tables) are not written. :meth:`TrainCheckpointer.restore` against a
``like`` template checks the whole tree first (structure, shapes, dtypes)
and only then copies every tensor into the template's own tensor, on the
template's device and in its dtype: a trainer that updates its parameters
in place keeps training the same tensors, and a failed restore leaves the
template untouched. Ints (adam's step count) come back exact.

**A multi-process fit** (``ctx.process_count > 1``) checkpoints one of
two ways. Its members under a supervisor (``distributed/context.py``)
pass ``factory`` (member-slice checkpoints, below) and ``on_chunk``, as
in the reference. Any other multi-process fit takes the plain path: the
reference's orbax manager coordinates a multi-host save (every process
takes part, replicated data written once), and the port's counterpart is
:class:`TrainCheckpointer` with the fit's ``ctx``. The primary alone
writes ``step-<n>.pt`` and every process waits at a barrier (an
``allgather_obj``) after each save; :meth:`TrainCheckpointer.latest_step`
is the primary's answer, ``delete_all`` runs on the primary alone
between two barriers, and a restore is used only when it loaded and
checked on every process. So every process resumes from the same step,
and none can read a step the primary has not finished writing.

**A fit whose processes split the state** passes a :class:`SplitLeaves`
layout: each leaf whole, or this process's slice of a whole leaf split
over one mesh axis on one dim, adam's moments as their parameter. The
transformer's tensor-parallel fit splits its Megatron projections over
``model``, its expert-parallel fit the experts over ``expert``, its
pipelined fit each stage's layers over ``pipe`` (``models/transformer.py:
checkpoint_layout``); the model-axis two-tower fit (``models/two_tower.py``)
passes :class:`RowBlocks`, every table's and moment's rows over
``model``. The plain path then writes whole leaves in the layout above,
the slices gathered over their axis first (on the leaves' device: an NCCL
group takes no host tensor), and a restore reads and checks the whole
leaves on every process and copies each process's slice into its
template. The whole state is what the reference's orbax manager saves of
the same fit, global arrays: for tensor and expert parallelism exactly
the state a one-process fit of the same config checkpoints, so each
resumes the other; for a pipeline the reference's stacked layers, one
``[n_layers, …]`` leaf a layer name, which a fit without the pipeline
fails to check and so trains afresh, as the reference's does. A
model-axis fit's member slices follow the reference's rule that a block's
``replica_id == 0`` holder writes it: the process at data coordinate 0 of
each model line writes its block's rows (``index`` ``[[lo, hi], None]``),
member 0 the whole leaves (the epoch, adam's count); a restore places
each block back on its owner.

**Member-slice checkpoints** (reference :245-453): the filesystem
protocol of ``distributed/checkpoint.py:DistSliceCheckpointer``, byte for
byte the reference's layout, so a directory written by either package
reads the same in the other::

    <dir>/slices/step-<s>/member-<m>.npz    one member's owned blocks
    <dir>/slices/step-<s>/member-<m>.json   manifest, written last
    <dir>/slices/commit-<s>.json            commit marker

Every write is atomic (``utils/fs``: a temporary file, fsync, rename);
numpy writes the npz (streamed into the file) and json the manifests
(sorted keys). A state is cut into a flat list
of leaves by :func:`state_leaves`, in the order ``jax.tree_util`` gives a
tree of dicts: dict keys sorted, then list and tuple entries in order; a
dataclass contributes its checkpointed fields in declaration order. Save
and restore both use that order, so a two-tower state
``{"params": [ue, ie], "opt": AdamTreeState, "epoch": e}`` is the leaves
``epoch, opt.count, opt.m[0], opt.m[1], opt.v[0], opt.v[1], params[0],
params[1]``. A Python int (adam's count) is an int64 0-d array. A bf16
tensor is written as numpy writes JAX's bfloat16 arrays, two-byte void
(``|V2``), bit for bit; :func:`place_leaves` reads such a leaf back into
a bf16 template bitwise (the reference cannot: ROADMAP.md Queue 3).
``row_sharding_for`` and ``restore_placed`` are the reference's JAX
placement helpers: the port restores onto the template's device
(:func:`place_leaves`), and the counterpart of ``row_sharding_for`` is
the serving placement after ``RecModel.load``: the tables land on the
context's device and sharded serving copies each shard's rows to its card
(``sharding/serve.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import re
import shutil
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from incubator_predictionio_tpu_torch.utils.fs import (
    atomic_write_bytes,
    atomic_write_with,
    fsync_dir,
)

logger = logging.getLogger(__name__)

_STEP_RE = re.compile(r"^step-(\d+)\.pt$")


def _fields(obj) -> list[str]:
    return [f.name for f in dataclasses.fields(obj)
            if f.metadata.get("checkpoint", True)]


def _to_plain(tree: Any) -> Any:
    """The tree as containers ``torch.load(weights_only=True)`` reads:
    dataclasses become dicts of their checkpointed fields; tensors are
    detached."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f: _to_plain(getattr(tree, f)) for f in _fields(tree)}
    if isinstance(tree, dict):
        return {k: _to_plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_plain(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


def _kind(value: Any) -> str:
    """A short description of a checkpoint's subtree, for an error: its
    keys, its length, its shape, or its type (not its values)."""
    if isinstance(value, dict):
        return f"keys {sorted(value)}"
    if isinstance(value, (list, tuple)):
        return f"{len(value)} entries"
    if isinstance(value, torch.Tensor):
        return f"{tuple(value.shape)} {value.dtype}"
    return type(value).__name__


def _check(like: Any, value: Any, path: str = "state") -> None:
    """Raise ``ValueError`` where ``value`` (a plain tree) does not fit the
    template ``like``."""
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        names = _fields(like)
        if not isinstance(value, dict) or sorted(value) != sorted(names):
            raise ValueError(f"{path}: fields {names}, checkpoint has "
                             f"{_kind(value)}")
        for f in names:
            _check(getattr(like, f), value[f], f"{path}.{f}")
    elif isinstance(like, dict):
        if not isinstance(value, dict) or sorted(value) != sorted(like):
            raise ValueError(f"{path}: keys {sorted(like)}, checkpoint has "
                             f"{_kind(value)}")
        for k in like:
            _check(like[k], value[k], f"{path}[{k!r}]")
    elif isinstance(like, (list, tuple)):
        if not isinstance(value, (list, tuple)) or len(value) != len(like):
            raise ValueError(f"{path}: {len(like)} entries, checkpoint has "
                             f"{_kind(value)}")
        for i, (a, b) in enumerate(zip(like, value)):
            _check(a, b, f"{path}[{i}]")
    elif isinstance(like, torch.Tensor):
        if not isinstance(value, torch.Tensor) or value.shape != like.shape \
                or value.dtype != like.dtype:
            raise ValueError(f"{path}: {tuple(like.shape)} {like.dtype}, "
                             f"checkpoint has {_kind(value)}")
    elif type(value) is not type(like):
        raise ValueError(f"{path}: {type(like).__name__}, checkpoint has "
                         f"{type(value).__name__}")


@torch.no_grad()
def _place(like: Any, value: Any) -> Any:
    """``value`` in ``like``'s structure; tensors copied into ``like``'s."""
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(
            like, **{f: _place(getattr(like, f), value[f]) for f in _fields(like)})
    if isinstance(like, dict):
        return {k: _place(v, value[k]) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_place(a, b) for a, b in zip(like, value))
    if isinstance(like, torch.Tensor):
        return like.copy_(value)
    return value


def _first_device(tree: Any) -> Optional[torch.device]:
    if isinstance(tree, torch.Tensor):
        return tree.device
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f) for f in _fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            d = _first_device(v)
            if d is not None:
                return d
    return None


class SplitLeaves:
    """The layout of a fit whose state holds slices of whole leaves
    (module docstring): every leaf is whole on every process, or this
    process's slice of a whole leaf split over one mesh axis on one dim,
    the slices of the axis's line joined on that dim in axis order.
    ``split(path)`` gives a parameter's ``(axis, dim)``, or None for a
    whole one; ``path`` is its keys in the parameter tree the whole state
    keeps, and adam's moments follow their parameter. ``view`` (with its
    inverse ``unview``) maps the fit's parameter list, and each moment
    list, to that tree (a pipeline's stacked layers); without it the whole
    state has the fit's own structure, the state a fit of the same
    config on one process checkpoints."""

    def __init__(self, ctx, split: Optional[Callable] = None,
                 view: Optional[Callable] = None,
                 unview: Optional[Callable] = None):
        self.ctx = ctx
        self._split = split
        self._view, self._unview = view, unview

    def split_of(self, path: tuple, leaf: Any) -> Optional[tuple[str, int]]:
        """The ``(axis, dim)`` of the state leaf at ``path``: a
        parameter's (``("params", *p)``) and each of its moments'
        (``("opt", field, *p)``) is ``split(p)``; the rest is whole."""
        if path[:1] == ("params",):
            return self._split(path[1:])
        if path[:1] == ("opt",) and len(path) > 2:
            return self._split(path[2:])
        return None

    def _pieces(self, state: Any) -> Any:
        """``state`` in the whole state's structure, each leaf this
        process's piece of its whole leaf."""
        return state if self._view is None else _map_params(self._view, state)

    def _whole_shape(self, path: tuple, leaf: Any) -> tuple:
        shape = tuple(leaf.shape)
        split = self.split_of(path, leaf)
        if split is None:
            return shape
        axis, dim = split
        return (*shape[:dim], shape[dim] * self.ctx.axis_size(axis),
                *shape[dim + 1:])

    def gather(self, state: Any) -> Any:
        """The whole state: every slice gathered over its axis on the
        leaf's device (a collective: every process of the job calls it;
        NCCL takes no host tensor) and joined on its dim."""
        def join(path, leaf):
            split = self.split_of(path, leaf)
            if split is None:
                return leaf
            axis, dim = split
            bits = leaf.detach().contiguous()
            if bits.dtype == torch.bfloat16:  # the bits through any backend
                bits = bits.view(torch.int16)
            parts = self.ctx.all_gather(bits, axis=axis)
            return torch.cat(tuple(parts), dim=dim).view(leaf.dtype)

        return _map_paths(join, self._pieces(state))

    def whole_like(self, like: Any) -> Any:
        """A template of the whole state: host tensors of the whole
        leaves' shapes and dtypes."""
        def whole(path, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            return torch.empty(self._whole_shape(path, leaf), dtype=leaf.dtype)

        return _map_paths(whole, self._pieces(_meta(like)))

    def cut(self, whole_leaves: list, like: Any) -> Any:
        """``whole_leaves`` (numpy, in :func:`state_leaves` order of the
        whole state) placed into ``like``: each slice takes its part of
        its whole leaf (:func:`place_leaves` checks every leaf before it
        writes)."""
        pieces = self._pieces(_meta(like))
        slots = list(_walk_paths(pieces))
        if len(slots) != len(whole_leaves):
            raise ValueError(f"the checkpoint has {len(whole_leaves)} leaves, "
                             f"the whole template {len(slots)}")
        out = []
        for (path, slot), leaf in zip(slots, whole_leaves):
            leaf = np.asarray(leaf)
            split = self.split_of(path, slot)
            if split is not None:
                axis, dim = split
                n, size = int(slot.shape[dim]), self.ctx.axis_size(axis)
                if leaf.ndim != slot.dim() or leaf.shape[dim] != n * size:
                    raise ValueError(
                        f"a whole leaf of shape {leaf.shape} does not hold "
                        f"{size} blocks of {n} on dim {dim}")
                lo = self.ctx.axis_index(axis) * n
                leaf = leaf[(slice(None),) * dim + (slice(lo, lo + n),)]
            out.append(leaf)
        local = _fill(pieces, iter(out))
        if self._unview is not None:
            local = _map_params(self._unview, local)
        return place_leaves(like, state_leaves(local))


class RowBlocks(SplitLeaves):
    """The layout of a model-axis fit's state (module docstring): every
    tensor leaf with a dimension is this process's row block of a leaf
    whose rows are the blocks of its ``model`` line in axis order (block
    ``s`` holds rows ``[s·R, (s+1)·R)``: dim 0 over ``model``); the other
    leaves (the epoch, adam's count) are whole on every process."""

    def __init__(self, ctx, axis: str = "model"):
        super().__init__(ctx)
        self.axis = axis
        self.shard = ctx.axis_index(axis)
        self.n_shards = ctx.axis_size(axis)
        # the block's replica_id == 0 holder: data coordinate 0
        self.writes_blocks = ctx.data_index == 0

    @staticmethod
    def is_block(leaf: Any) -> bool:
        return isinstance(leaf, torch.Tensor) and leaf.dim() >= 1

    def split_of(self, path: tuple, leaf: Any) -> Optional[tuple[str, int]]:
        return (self.axis, 0) if self.is_block(leaf) else None

    def global_shape(self, leaf: Any) -> tuple:
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        if not self.is_block(leaf):
            return shape
        return (shape[0] * self.n_shards, *shape[1:])

    def bounds(self, leaf: torch.Tensor) -> tuple[int, int]:
        """``[lo, hi)``: the rows of the whole leaf this block holds."""
        rows = int(leaf.shape[0])
        return self.shard * rows, (self.shard + 1) * rows

    def member_blocks(self, leaf: Any, member: int) -> list:
        """The blocks of ``leaf`` a member writes in a member slice:
        ``[(host_array, index)]``."""
        if not self.is_block(leaf):
            return [(leaf_to_numpy(leaf), None)] if member == 0 else []
        if not self.writes_blocks:
            return []
        lo, hi = self.bounds(leaf)
        return [(leaf_to_numpy(leaf), [[lo, hi]] + [None] * (leaf.dim() - 1))]


def _meta(tree: Any) -> Any:
    """``tree`` with every tensor replaced by a meta tensor of its shape
    and dtype (shapes to compute with, no storage)."""
    return _map_leaves(lambda leaf: torch.empty_like(leaf, device="meta")
                       if isinstance(leaf, torch.Tensor) else leaf, tree)


def _map_params(fn, state: dict) -> dict:
    """``state`` (``{"params", "opt", ...}``) with ``fn`` applied to its
    parameters and to each of the optimizer's moments (the containers
    among its checkpointed fields)."""
    opt = state["opt"]
    moments = {f: fn(getattr(opt, f)) for f in _fields(opt)
               if isinstance(getattr(opt, f), (list, tuple, dict))}
    return {**state, "params": fn(state["params"]),
            "opt": dataclasses.replace(opt, **moments)}


def _map_leaves(fn, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf (the containers of
    :func:`_walk`; a dataclass's unchecked fields are kept as they are)."""
    return _map_paths(lambda _, leaf: fn(leaf), tree)


def _map_paths(fn, tree: Any, path: tuple = ()) -> Any:
    """``tree`` with ``fn(path, leaf)`` applied to every leaf, ``path``
    the leaf's keys (dict keys, list indices, dataclass field names)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f: _map_paths(fn, getattr(tree, f), (*path, f)) for f in _fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, (*path, i)) for i, v in enumerate(tree))
    return fn(path, tree)


class TrainCheckpointer:
    """Step-indexed state checkpoints in ``directory`` (created on demand).
    With a multi-process ``ctx``, the plain path of a multi-process fit
    (module docstring): the primary writes, the others wait; with a
    :class:`RowBlocks` ``layout``, of whole leaves gathered from the
    processes' blocks; with a :class:`SplitLeaves` one, of whole leaves
    gathered from the processes' slices."""

    def __init__(self, directory: str, max_to_keep: int = 3, ctx=None,
                 layout: Optional[SplitLeaves] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._ctx = ctx if ctx is not None and ctx.process_count > 1 else None
        self._layout = layout
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{int(step)}.pt")

    @property
    def _writes(self) -> bool:
        return self._ctx is None or self._ctx.is_primary

    def _barrier(self, what) -> list:
        return [] if self._ctx is None else self._ctx.allgather_obj(what)

    def save(self, step: int, state: Any) -> None:
        """Durable by the time it returns: the step's file is written to a
        temporary name, fsynced and renamed into place, and the directory
        fsynced. Then the oldest steps past ``max_to_keep`` are dropped.
        With a multi-process ``ctx`` the primary writes and every process
        returns only once it has."""
        t0 = time.perf_counter()
        if self._layout is not None:
            state = self._layout.gather(state)
        t_gather = time.perf_counter() - t0
        written = 0
        if self._writes:
            plain = _to_plain(state)
            written = sum(t.numel() * t.element_size() for t in _walk(plain)
                          if isinstance(t, torch.Tensor))
            atomic_write_with(self._path(step), lambda f: torch.save(plain, f))
            steps = self.all_steps()
            if self.max_to_keep and len(steps) > self.max_to_keep:
                for old in steps[: len(steps) - self.max_to_keep]:
                    os.remove(self._path(old))
                fsync_dir(self.directory)
        seen = self._barrier(("save", int(step)))
        if seen and len(set(seen)) != 1:
            raise RuntimeError(f"checkpoint save: the processes saved "
                               f"different steps {seen}")
        logger.info("checkpoint: step %d saved in %.3f s (layout gather "
                    "%.3f s; %d bytes written by this process) in %s", step,
                    time.perf_counter() - t0, t_gather, written, self.directory)

    def latest_step(self) -> Optional[int]:
        """The newest step (the primary's answer under a multi-process
        ``ctx``)."""
        steps = self.all_steps() if self._writes else []
        latest = steps[-1] if steps else None
        return latest if self._ctx is None else self._ctx.allgather_obj(latest)[0]

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_RE.match,
                                                   os.listdir(self.directory))
                      if m)

    def delete_all(self) -> None:
        """Drop every saved step (stale state from a prior completed run);
        on the primary alone under a multi-process ``ctx``, between two
        barriers."""
        self._barrier("delete")
        if self._writes:
            for step in self.all_steps():
                os.remove(self._path(step))
            fsync_dir(self.directory)
        self._barrier("deleted")

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """Restore ``step`` (default: latest). With ``like``, the state
        comes back in the template's structure, its tensors copied into the
        template's (see the module docstring); without it, as plain
        containers of CPU tensors. Under a multi-process ``ctx`` every
        process loads and checks the step, and the template is written only
        when all of them succeeded; else every process raises."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        t0 = time.perf_counter()
        if self._layout is not None and like is not None:
            whole = self._restore(step, self._layout.whole_like(like))
            t_read = time.perf_counter() - t0
            out = self._layout.cut(
                [leaf_to_numpy(x) for x in state_leaves(whole)], like)
        else:
            out = self._restore(step, like)
            t_read = time.perf_counter() - t0
        logger.info("checkpoint: step %d restored in %.3f s (read and "
                    "checked %.3f s) from %s", step, time.perf_counter() - t0,
                    t_read, self.directory)
        return out

    def _restore(self, step: int, like: Any) -> Any:
        device = _first_device(like) if like is not None else None
        error = None
        try:
            value = torch.load(self._path(step), weights_only=True,
                               map_location=device or "cpu")
            if like is not None:
                _check(like, value)
        except Exception as e:  # noqa: BLE001 — relayed to every process
            error = e
        failed = [i for i, err in enumerate(self._barrier(
            None if error is None else repr(error))) if err is not None]
        if error is not None:
            raise error
        if failed:
            raise RuntimeError(f"checkpoint step {step} failed to restore on "
                               f"process(es) {failed}")
        if like is None:
            return value
        return _place(like, value)

    def close(self) -> None:
        pass

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def scalar(x: int) -> torch.Tensor:
    """Wrap a Python int as a tensor leaf (the epoch a checkpoint holds)."""
    return torch.tensor(int(x), dtype=torch.int32)


def maybe_resume(
    directory: Optional[str],
    every: int,
    keep: int,
    params: Any,
    opt_state: Any,
    epochs: int,
    factory=None,
    ctx=None,
    layout: Optional[SplitLeaves] = None,
) -> tuple[Optional[TrainCheckpointer], Any, Any, int]:
    """Open a checkpointer and resume an interrupted run if one is
    recoverable: ``(ckpt, params, opt_state, start_epoch)``. Three outcomes
    train from scratch (``start_epoch == 0``):

    - checkpointing disabled (no directory / ``every <= 0``): ``ckpt is None``;
    - the restore fails (e.g. the tables' shapes changed with the data):
      the stale state is deleted;
    - the latest step is ≥ ``epochs``: state of a prior *completed* run,
      deleted too (before any of it is read).

    The caller owns ``ckpt.close()``. ``factory`` (default
    :class:`TrainCheckpointer`, given ``ctx``) swaps the checkpointer
    implementation; ``layout`` (a :class:`SplitLeaves`: a fit whose
    processes hold slices of the state) goes to either."""
    if not directory or every <= 0:
        return None, params, opt_state, 0
    if factory is None:
        ck = TrainCheckpointer(directory, max_to_keep=keep, ctx=ctx,
                               layout=layout)
    elif layout is not None:
        ck = factory(directory, max_to_keep=keep, layout=layout)
    else:
        ck = factory(directory, max_to_keep=keep)
    latest = ck.latest_step()
    if latest is None:
        return ck, params, opt_state, 0
    # a step is the number of epochs its state has trained: a completed
    # run's state is refused before anything is copied into the template
    if latest >= epochs:
        logger.warning(
            "checkpoint at epoch %d >= epochs %d in %s: stale completed-run "
            "state, restarting fresh", latest, epochs, directory,
        )
        ck.delete_all()
        return ck, params, opt_state, 0
    try:
        state = ck.restore(latest, like={"params": params, "opt": opt_state,
                                         "epoch": scalar(0)})
    except Exception as e:  # noqa: BLE001 — any restore failure ⇒ fresh start
        logger.warning(
            "checkpoint restore from %s failed (%s): restarting fresh",
            directory, e,
        )
        ck.delete_all()
        return ck, params, opt_state, 0
    resumed = int(state["epoch"])
    logger.info("checkpoint: resuming from epoch %d (of %d) in %s",
                resumed, epochs, directory)
    return ck, state["params"], state["opt"], resumed


def checkpointed_epochs(
    directory: Optional[str],
    every: int,
    keep: int,
    epochs: int,
    params: Any,
    opt_state: Any,
    train_epochs,
    factory=None,
    on_chunk=None,
    ctx=None,
    layout: Optional[SplitLeaves] = None,
) -> tuple[Any, Any, Any]:
    """The shared epoch driver both trainers run: resume through
    :func:`maybe_resume`, then ``train_epochs(params, opt_state, n) ->
    (params, opt_state, loss)`` over all remaining epochs in one call when
    checkpointing is off, else ``every`` epochs a call with a save after
    each. ``on_chunk(epoch)`` runs at each chunk boundary; ``ctx`` is the
    fit's context (a multi-process fit without ``factory`` takes the plain
    path, module docstring); ``layout`` describes the slices of a fit whose
    processes split the state (:class:`SplitLeaves`, :class:`RowBlocks`
    for a model-axis fit's row blocks). Returns ``(params, opt_state, loss)``;
    ``loss`` is None when no epoch ran. Each chunk runs inside a
    ``train_epochs#<epoch>`` profiler range (reference checkpoint.py:212).
    """
    from incubator_predictionio_tpu_torch.utils.tracing import step_annotation

    ckpt, params, opt_state, start_epoch = maybe_resume(
        directory, every, keep, params, opt_state, epochs, factory=factory,
        ctx=ctx, layout=layout)
    loss = None
    try:
        e = start_epoch
        while e < epochs:
            if on_chunk is not None:
                on_chunk(e)
            chunk = min(every, epochs - e) if ckpt is not None else epochs - e
            with step_annotation("train_epochs", e):
                params, opt_state, loss = train_epochs(params, opt_state, chunk)
            e += chunk
            if ckpt is not None:
                ckpt.save(e, {"params": params, "opt": opt_state,
                              "epoch": scalar(e)})
    finally:
        if ckpt is not None:
            ckpt.close()
    return params, opt_state, loss


# -- a state as a flat list of numpy leaves ---------------------------------

def _walk(tree: Any):
    """The leaves of ``tree`` in the module docstring's order: tensors and
    Python ints (anything else that is not a container is a leaf too)."""
    for _, leaf in _walk_paths(tree):
        yield leaf


def _walk_paths(tree: Any, path: tuple = ()):
    """``(path, leaf)`` of every leaf of ``tree``, in :func:`_walk`'s order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in _fields(tree):
            yield from _walk_paths(getattr(tree, f), (*path, f))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk_paths(tree[k], (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk_paths(v, (*path, i))
    else:
        yield path, tree


def _fill(tree: Any, leaves, put=lambda slot, leaf: leaf) -> Any:
    """``tree``'s structure with each slot replaced by ``put(slot, leaf)``,
    the leaves taken from the iterator ``leaves`` in :func:`_walk`'s order
    (a dict filled in sorted order, kept in its own)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f: _fill(getattr(tree, f), leaves, put) for f in _fields(tree)})
    if isinstance(tree, dict):
        vals = {k: _fill(tree[k], leaves, put) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, leaves, put) for v in tree)
    return put(tree, next(leaves))


def leaf_to_numpy(leaf: Any) -> np.ndarray:
    """One leaf as the host array a member slice stores: a tensor's bytes
    (bf16 as two-byte void, numpy's layout of JAX's bfloat16), an int as
    an int64 0-d array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    if isinstance(leaf, bool) or not isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf)
    return np.asarray(leaf, np.int64)


def state_leaves(tree: Any) -> list:
    """The leaves of a checkpointed state, in save order (module
    docstring), as they are: tensors stay on their device."""
    return list(_walk(tree))


def _fits(like: Any, leaf: np.ndarray, i: int) -> None:
    if isinstance(like, torch.Tensor):
        want = (np.dtype("V2") if like.dtype == torch.bfloat16
                else torch.empty((), dtype=like.dtype).numpy().dtype)
        ok = tuple(leaf.shape) == tuple(like.shape) and (
            leaf.dtype == want or (like.dtype == torch.bfloat16
                                   and leaf.dtype in (np.int16, np.uint16)))
        if not ok:
            raise ValueError(f"leaf {i}: template {tuple(like.shape)} "
                             f"{like.dtype}, checkpoint has {leaf.shape} "
                             f"{leaf.dtype}")
    elif isinstance(like, (int, np.integer)) and not isinstance(like, bool):
        if leaf.shape != () or leaf.dtype.kind not in "iu":
            raise ValueError(f"leaf {i}: template is an int, checkpoint has "
                             f"{leaf.shape} {leaf.dtype}")
    elif leaf.shape != np.shape(like):
        raise ValueError(f"leaf {i}: template {np.shape(like)}, checkpoint "
                         f"has {leaf.shape}")


@torch.no_grad()
def place_leaves(like: Any, leaves: list) -> Any:
    """``leaves`` (numpy, in :func:`state_leaves` order) in ``like``'s
    structure: every leaf is checked against the template first (count,
    shapes, dtypes), then each tensor is copied into the template's own
    tensor on its device (a bf16 leaf bit for bit), each int comes back
    exact. A failed check leaves the template untouched."""
    slots = state_leaves(like)
    if len(slots) != len(leaves):
        raise ValueError(f"the checkpoint has {len(leaves)} leaves, the "
                         f"template {len(slots)}")
    for i, (a, b) in enumerate(zip(slots, leaves)):
        _fits(a, np.asarray(b), i)

    def put(slot, leaf):
        leaf = np.asarray(leaf)
        if isinstance(slot, torch.Tensor):
            if slot.dtype == torch.bfloat16:
                src = torch.from_numpy(np.ascontiguousarray(leaf).view(
                    np.int16).copy()).view(torch.bfloat16)
            else:
                src = torch.from_numpy(np.array(leaf, copy=True))
            return slot.copy_(src)
        if isinstance(slot, (int, np.integer)) and not isinstance(slot, bool):
            return int(leaf)
        return leaf

    return _fill(like, iter(leaves), put)


# -- member-slice checkpoints: the filesystem protocol (reference :245-453) --
#
# The distributed training tier checkpoints by SLICE: each mesh member
# writes only the blocks it owns, and a step becomes restorable only once a
# commit marker exists, written after every member's slice is durable. A
# kill between two members' slice writes leaves step-<s> without a commit
# marker; restore then uses the previous committed step, so two histories
# can never compose.

SLICES_DIR = "slices"


def slice_step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), SLICES_DIR, f"step-{int(step)}")


def _commit_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), SLICES_DIR,
                        f"commit-{int(step)}.json")


def save_member_slice(
    directory: str,
    step: int,
    member: int,
    generation: int,
    entries: list[dict],
    arrays: dict[str, np.ndarray],
) -> None:
    """Durably write one member's slice for ``step``.

    ``entries`` describe the payload (one per saved block):
    ``{"key": <npz key>, "leaf": <flat leaf index>, "globalShape": [...],
    "index": [[lo, hi] | None per dim]}``; ``index`` row-bounds the block
    inside the full leaf, and ``None`` (or all-``None``) means the member
    holds the whole leaf. Data lands first (atomic npz), the manifest last:
    manifest presence is the per-member durability marker the committer
    polls for.
    """
    d = slice_step_dir(directory, step)
    os.makedirs(d, exist_ok=True)
    # streamed into the temporary file: the reference's bytes, without a
    # second copy of the slice in memory
    atomic_write_with(os.path.join(d, f"member-{int(member)}.npz"),
                      lambda f: np.savez(f, **{k: np.asarray(v)
                                               for k, v in arrays.items()}))
    manifest = {"step": int(step), "member": int(member),
                "generation": int(generation), "entries": entries}
    atomic_write_bytes(os.path.join(d, f"member-{int(member)}.json"),
                       json.dumps(manifest, sort_keys=True).encode("utf-8"))


def read_member_slice(directory: str, step: int, member: int):
    """``(manifest, arrays)`` for one member's durable slice, or ``None``
    when the manifest is absent (slice not finished)."""
    d = slice_step_dir(directory, step)
    manifest = _read_json(os.path.join(d, f"member-{int(member)}.json"))
    if manifest is None:
        return None
    with np.load(os.path.join(d, f"member-{int(member)}.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return manifest, arrays


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError):
        return None


def members_done(directory: str, step: int, members: int, generation: int) -> list[int]:
    """Ranks whose slice for ``(step, generation)`` is durable: the
    committer's poll predicate. A manifest from another generation does NOT
    count: mixing a dead mesh's slice into a new commit is exactly the
    composed-history corruption the marker exists to prevent."""
    d = slice_step_dir(directory, step)
    done = []
    for m in range(members):
        manifest = _read_json(os.path.join(d, f"member-{m}.json"))
        if manifest is not None and int(manifest.get("generation", -1)) == int(generation):
            done.append(m)
    return done


def write_commit_marker(directory: str, step: int, generation: int,
                        members: int) -> None:
    """The coordinated-commit point: atomic and durable, so a visible
    marker implies every slice it covers is on disk."""
    os.makedirs(os.path.join(os.path.abspath(directory), SLICES_DIR),
                exist_ok=True)
    atomic_write_bytes(_commit_path(directory, step), json.dumps({
        "step": int(step), "generation": int(generation),
        "members": int(members), "committedAt": time.time(),
    }, sort_keys=True).encode("utf-8"))


def read_commit_marker(directory: str, step: int) -> Optional[dict]:
    return _read_json(_commit_path(directory, step))


def committed_steps(directory: str) -> list[int]:
    """Steps with a commit marker, ascending: the only restorable steps."""
    d = os.path.join(os.path.abspath(directory), SLICES_DIR)
    try:
        names = os.listdir(d)
    except OSError:
        return []
    out = []
    for name in names:
        if name.startswith("commit-") and name.endswith(".json"):
            try:
                out.append(int(name[len("commit-"):-len(".json")]))
            except ValueError:
                continue
    return sorted(out)


def gc_slice_steps(directory: str, keep: int) -> None:
    """Retention: drop all but the newest ``keep`` committed steps (marker
    first, then the slice dir: a crash between the two leaves an orphan
    dir, which is garbage but never restorable). Uncommitted step dirs
    older than the newest commit (leftovers of a dead generation) go too."""
    steps = committed_steps(directory)
    if not steps:
        return
    latest = steps[-1]
    for s in steps[:-max(1, keep)] if keep > 0 else []:
        with contextlib.suppress(OSError):
            os.unlink(_commit_path(directory, s))
        shutil.rmtree(slice_step_dir(directory, s), ignore_errors=True)
    base = os.path.join(os.path.abspath(directory), SLICES_DIR)
    kept = set(committed_steps(directory))
    for name in os.listdir(base):
        if not name.startswith("step-"):
            continue
        try:
            s = int(name[len("step-"):])
        except ValueError:
            continue
        if s < latest and s not in kept:
            shutil.rmtree(os.path.join(base, name), ignore_errors=True)


def assemble_committed_step(directory: str, step: int) -> list[np.ndarray]:
    """Reassemble the full flat leaf list of a COMMITTED step from its
    member slices. Every leaf must be fully covered by exactly the slices
    of the commit's generation: partial coverage (a history torn across
    generations could produce it) raises instead of returning a mix.
    """
    commit = read_commit_marker(directory, step)
    if commit is None:
        raise FileNotFoundError(
            f"step {step} has no commit marker under {directory}")
    generation, members = int(commit["generation"]), int(commit["members"])
    leaves: dict[int, np.ndarray] = {}
    covered: dict[int, list[tuple[int, int]]] = {}
    for m in range(members):
        got = read_member_slice(directory, step, m)
        if got is None:
            raise FileNotFoundError(
                f"committed step {step} is missing member {m}'s slice")
        manifest, arrays = got
        if int(manifest.get("generation", -1)) != generation:
            raise ValueError(
                f"member {m} slice at step {step} is generation "
                f"{manifest.get('generation')} but the commit is {generation}")
        for e in manifest["entries"]:
            leaf = int(e["leaf"])
            block = arrays[e["key"]]
            shape = tuple(e["globalShape"])
            if leaf not in leaves:
                leaves[leaf] = np.zeros(shape, dtype=block.dtype)
                covered[leaf] = []
            index = e.get("index")
            if not index or all(i is None for i in index):
                leaves[leaf][...] = block
                covered[leaf].append((0, shape[0] if shape else 1))
            else:
                lo, hi = int(index[0][0]), int(index[0][1])
                leaves[leaf][lo:hi, ...] = block
                covered[leaf].append((lo, hi))
    out = []
    for leaf in sorted(leaves):
        shape = leaves[leaf].shape
        rows = shape[0] if shape else 1
        pos = 0
        for lo, hi in sorted(covered[leaf]):
            if lo > pos:
                break
            pos = max(pos, hi)
        if pos < rows:
            raise ValueError(
                f"leaf {leaf} of step {step} only covered to row {pos} of "
                f"{rows}: refusing a partially-assembled restore")
        out.append(leaves[leaf])
    return out
