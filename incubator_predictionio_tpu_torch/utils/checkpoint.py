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

The multi-process member-slice protocol (reference :245 on) comes with
the sharding slice (ROADMAP.md Queue 1, item 4); ``factory`` and
``on_chunk`` are its seams, as in the reference.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import Any, Optional

import torch

from incubator_predictionio_tpu_torch.utils.fs import atomic_write_with, fsync_dir

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


def _check(like: Any, value: Any, path: str = "state") -> None:
    """Raise ``ValueError`` where ``value`` (a plain tree) does not fit the
    template ``like``."""
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        names = _fields(like)
        if not isinstance(value, dict) or sorted(value) != sorted(names):
            raise ValueError(f"{path}: fields {names}, checkpoint has "
                             f"{sorted(value) if isinstance(value, dict) else value!r}")
        for f in names:
            _check(getattr(like, f), value[f], f"{path}.{f}")
    elif isinstance(like, dict):
        if not isinstance(value, dict) or sorted(value) != sorted(like):
            raise ValueError(f"{path}: keys {sorted(like)}, checkpoint has "
                             f"{sorted(value) if isinstance(value, dict) else value!r}")
        for k in like:
            _check(like[k], value[k], f"{path}[{k!r}]")
    elif isinstance(like, (list, tuple)):
        if not isinstance(value, (list, tuple)) or len(value) != len(like):
            raise ValueError(f"{path}: {len(like)} entries, checkpoint has "
                             f"{len(value) if isinstance(value, (list, tuple)) else value!r}")
        for i, (a, b) in enumerate(zip(like, value)):
            _check(a, b, f"{path}[{i}]")
    elif isinstance(like, torch.Tensor):
        if not isinstance(value, torch.Tensor) or value.shape != like.shape \
                or value.dtype != like.dtype:
            raise ValueError(
                f"{path}: {tuple(like.shape)} {like.dtype}, checkpoint has "
                + (f"{tuple(value.shape)} {value.dtype}"
                   if isinstance(value, torch.Tensor) else repr(value)))
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


class TrainCheckpointer:
    """Step-indexed state checkpoints in ``directory`` (created on demand)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{int(step)}.pt")

    def save(self, step: int, state: Any) -> None:
        """Durable by the time it returns: the step's file is written to a
        temporary name, fsynced and renamed into place, and the directory
        fsynced. Then the oldest steps past ``max_to_keep`` are dropped."""
        plain = _to_plain(state)
        atomic_write_with(self._path(step), lambda f: torch.save(plain, f))
        steps = self.all_steps()
        if self.max_to_keep and len(steps) > self.max_to_keep:
            for old in steps[: len(steps) - self.max_to_keep]:
                os.remove(self._path(old))
            fsync_dir(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_RE.match,
                                                   os.listdir(self.directory))
                      if m)

    def delete_all(self) -> None:
        """Drop every saved step (stale state from a prior completed run)."""
        for step in self.all_steps():
            os.remove(self._path(step))
        fsync_dir(self.directory)

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """Restore ``step`` (default: latest). With ``like``, the state
        comes back in the template's structure, its tensors copied into the
        template's (see the module docstring); without it, as plain
        containers of CPU tensors."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        device = _first_device(like) if like is not None else None
        value = torch.load(self._path(step), weights_only=True,
                           map_location=device or "cpu")
        if like is None:
            return value
        _check(like, value)
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
    :class:`TrainCheckpointer`) swaps the checkpointer implementation."""
    if not directory or every <= 0:
        return None, params, opt_state, 0
    ck = (factory or TrainCheckpointer)(directory, max_to_keep=keep)
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
) -> tuple[Any, Any, Any]:
    """The shared epoch driver both trainers run: resume through
    :func:`maybe_resume`, then ``train_epochs(params, opt_state, n) ->
    (params, opt_state, loss)`` over all remaining epochs in one call when
    checkpointing is off, else ``every`` epochs a call with a save after
    each. ``on_chunk(epoch)`` runs at each chunk boundary. Returns
    ``(params, opt_state, loss)``; ``loss`` is None when no epoch ran."""
    ckpt, params, opt_state, start_epoch = maybe_resume(
        directory, every, keep, params, opt_state, epochs, factory=factory)
    loss = None
    try:
        e = start_epoch
        while e < epochs:
            if on_chunk is not None:
                on_chunk(e)
            chunk = min(every, epochs - e) if ckpt is not None else epochs - e
            params, opt_state, loss = train_epochs(params, opt_state, chunk)
            e += chunk
            if ckpt is not None:
                ckpt.save(e, {"params": params, "opt": opt_state,
                              "epoch": scalar(e)})
    finally:
        if ckpt is not None:
            ckpt.close()
    return params, opt_state, loss
