"""DistSliceCheckpointer — coordinated slice checkpoints of a supervised fit.

Counterpart of ``incubator_predictionio_tpu/distributed/checkpoint.py``.
A drop-in for ``utils/checkpoint.py:TrainCheckpointer`` (the same
``save / latest_step / all_steps / restore(like=) / delete_all / close``
surface, injected through ``maybe_resume(factory=...)``), where each mesh
member writes only the blocks it OWNS and a step is restorable only once
member 0 has written the commit marker, which it does strictly after
seeing every member's slice durable on the shared filesystem.

Two-phase discipline (the filesystem protocol is in
``utils/checkpoint.py``):

1. every member: atomic npz (data), then atomic manifest (the done
   marker), both carrying the member's mesh **generation**;
2. member 0: poll for all ``members`` manifests of its own generation
   (``commit_timeout_ms``), re-check the fencing token last, then write
   ``commit-<step>.json``, mirror it into the mesh directory and drop the
   steps past ``max_to_keep``.

A kill anywhere in phase 1 or 2 leaves the step uncommitted, so restore
uses the previous commit; a zombie from an older generation fails the
fence check (before it touches disk, and again before it commits); a
slice written by an older generation never satisfies the phase-2 poll.

Ownership follows the reference's rule for the port's layout: a block's
``replica_id == 0`` holder writes it. A data-parallel fit's tables are
replicated, and the reference gives a replicated leaf to its shard on
process 0: member 0 writes every leaf whole and the other members write
manifests with no entries. A model-axis fit passes its
``utils/checkpoint.py:RowBlocks`` layout: the process at data coordinate
0 of each model line writes its block's rows of every table and moment,
member 0 the whole leaves (the epoch, adam's count), and a restore
places each block back on its owner. ``slice_fn`` overrides both
(tests, row blocks): ``slice_fn(leaf_idx, leaf, member, members)`` gets
the leaf as a host array and returns ``[(block, index_or_None), ...]``,
``index`` being ``[[lo, hi], None, ...]`` for a row block. The leaves and
their order are ``utils/checkpoint.py:state_leaves``'s; ``restore(like=)``
copies into the template's own tensors on their device.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Any, Callable, Optional

import numpy as np

from incubator_predictionio_tpu_torch.distributed import dist_metrics
from incubator_predictionio_tpu_torch.distributed.errors import (
    FencedGenerationError,
    MemberLostError,
)
from incubator_predictionio_tpu_torch.distributed.meshdir import MeshDirectory
from incubator_predictionio_tpu_torch.resilience.clock import SYSTEM_CLOCK, Clock
from incubator_predictionio_tpu_torch.utils import checkpoint as ckpt_fs

logger = logging.getLogger(__name__)

#: commit-poll cadence: cheap manifest reads on a local or shared fs
_POLL_S = 0.025


class DistSliceCheckpointer:
    """Slice-aware checkpointer for one mesh member."""

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        members: int = 1,
        member: int = 0,
        generation: int = 0,
        meshdir: Optional[MeshDirectory] = None,
        slice_fn: Optional[Callable] = None,
        clock: Clock = SYSTEM_CLOCK,
        commit_timeout_ms: int = 60_000,
        layout: Optional["ckpt_fs.RowBlocks"] = None,
    ):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.members = int(members)
        self.member = int(member)
        self.generation = int(generation)
        self.meshdir = meshdir
        self._slice_fn = slice_fn
        self._clock = clock
        self.commit_timeout_ms = commit_timeout_ms
        self._layout = layout

    # -- TrainCheckpointer surface ----------------------------------------
    def save(self, step: int, state: Any) -> None:
        """Write this member's slice; on member 0, also drive the commit.
        Returning means: my slice is durable, and (member 0 only) the step
        is committed. Raises :class:`FencedGenerationError` before touching
        disk when the mesh has moved on."""
        self._check_fence()
        t0 = time.perf_counter()
        entries, arrays = [], {}
        for i, leaf in enumerate(ckpt_fs.state_leaves(state)):
            for j, (block, index) in enumerate(self._local_blocks(i, leaf)):
                key = f"l{i}b{j}"
                shape = (_shape(leaf) if self._layout is None
                         else self._layout.global_shape(leaf))
                entries.append({
                    "key": key, "leaf": i,
                    "globalShape": [int(s) for s in shape],
                    "index": index,
                })
                arrays[key] = block
        ckpt_fs.save_member_slice(self.directory, step, self.member,
                                  self.generation, entries, arrays)
        t1 = time.perf_counter()
        if self.member == 0:
            self._commit(step)
        logger.info("dist checkpoint: member %d step %d: slice of %d bytes "
                    "written in %.1f ms, commit %.1f ms", self.member, step,
                    sum(np.asarray(a).nbytes for a in arrays.values()), (t1 - t0) * 1e3,
                    (time.perf_counter() - t1) * 1e3)

    def latest_step(self) -> Optional[int]:
        steps = ckpt_fs.committed_steps(self.directory)
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return ckpt_fs.committed_steps(self.directory)

    def delete_all(self) -> None:
        shutil.rmtree(os.path.join(self.directory, ckpt_fs.SLICES_DIR),
                      ignore_errors=True)

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """A COMMITTED step's leaves (every member restores the whole
        state); with ``like``, copied into the template
        (``utils/checkpoint.py:place_leaves``), else the host arrays."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed steps under {self.directory}")
        leaves = ckpt_fs.assemble_committed_step(self.directory, step)
        if like is None:
            return leaves
        if self._layout is not None:
            return self._layout.cut(leaves, like)
        return ckpt_fs.place_leaves(like, leaves)

    def close(self) -> None:
        """No handle to release (parity with TrainCheckpointer)."""

    def __enter__(self) -> "DistSliceCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- slicing -----------------------------------------------------------
    def _local_blocks(self, leaf_idx: int, leaf: Any) -> list:
        """Blocks of ``leaf`` this member owns: ``[(host_array, index),
        ...]``. Without ``slice_fn``: the layout's blocks (module
        docstring), or every leaf whole on member 0 (the replicated
        layout) and nothing elsewhere; only the owner copies the leaf to
        the host."""
        if self._slice_fn is not None:
            return list(self._slice_fn(leaf_idx, ckpt_fs.leaf_to_numpy(leaf),
                                       self.member, self.members))
        if self._layout is not None:
            return self._layout.member_blocks(leaf, self.member)
        return [(ckpt_fs.leaf_to_numpy(leaf), None)] if self.member == 0 else []

    # -- commit ------------------------------------------------------------
    def _check_fence(self) -> None:
        if self.meshdir is None:
            return
        current, _ = self.meshdir.read_generation()
        if current > self.generation:
            dist_metrics.DIST_FENCED.inc()
            raise FencedGenerationError(
                f"mesh generation is {current}, this member holds "
                f"{self.generation}: fenced, refusing to touch checkpoints")

    def _commit(self, step: int) -> None:
        deadline = self._clock.monotonic() + self.commit_timeout_ms / 1000.0
        while True:
            done = ckpt_fs.members_done(self.directory, step, self.members,
                                        self.generation)
            if len(done) == self.members:
                break
            self._check_fence()
            if self._clock.monotonic() >= deadline:
                dist_metrics.DIST_STEP_ABORTS.inc()
                missing = sorted(set(range(self.members)) - set(done))
                raise MemberLostError(
                    f"checkpoint step {step}: members {missing} did not "
                    f"write their slice within {self.commit_timeout_ms}ms")
            self._clock.sleep(_POLL_S)
        # the token may have moved while we polled: a commit from a fenced
        # generation is exactly the composed-history fault, so re-check LAST
        self._check_fence()
        ckpt_fs.write_commit_marker(self.directory, step, self.generation,
                                    self.members)
        dist_metrics.DIST_COMMITS.inc()
        if self.meshdir is not None:
            self.meshdir.record_commit(step, self.generation)
        ckpt_fs.gc_slice_steps(self.directory, self.max_to_keep)
        logger.info("dist checkpoint: committed step %d (generation %d, "
                    "%d members)", step, self.generation, self.members)


def _shape(leaf: Any) -> tuple:
    shape = getattr(leaf, "shape", None)
    return tuple(shape) if shape is not None else np.shape(leaf)
