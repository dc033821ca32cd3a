"""Failure vocabulary of the distributed training tier.

Counterpart of ``incubator_predictionio_tpu/distributed/errors.py``. Both
errors are verdicts, not bugs: they name the two ways a member falls out
of a mesh, and callers (the epoch driver, the supervisor) branch on them.
"""

from __future__ import annotations


class MemberLostError(RuntimeError):
    """A peer stopped answering within its heartbeat lease (or a collective
    failed outright). The step is lost; the supervisor bumps the generation
    and re-forms the mesh, and training resumes from the last commit."""


class FencedGenerationError(RuntimeError):
    """This process's mesh generation is older than the directory's: it is
    a zombie from a torn-down mesh. It must neither commit a checkpoint nor
    answer a collective; the only correct move is to stop."""
