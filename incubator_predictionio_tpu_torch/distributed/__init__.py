"""Fault-tolerant multi-process TRAINING tier.

Counterpart of ``incubator_predictionio_tpu/distributed/`` (the same
``__all__``). N member processes form one ``torch.distributed`` group and
train one replica each. Robustness rides three pieces:

- :mod:`.meshdir`: a durable coordination directory (heartbeat leases and
  a monotonic mesh **generation**, the fencing token) shared by the
  members and their supervisor;
- :mod:`.checkpoint`: coordinated slice checkpoints: every member saves
  the blocks it owns, and a commit marker lands only after all slices are
  durable, so a kill between slices can never compose two histories;
- :mod:`.context` / :mod:`.supervisor`: the in-process guard (collective
  loss detection, generation fencing, self-abort on lost peers) and the
  process-level supervisor that detects member loss, bumps the
  generation, re-forms the mesh and resumes from the last commit.
"""

from incubator_predictionio_tpu_torch.distributed.checkpoint import DistSliceCheckpointer
from incubator_predictionio_tpu_torch.distributed.context import (
    DistConfig,
    DistContext,
    FencedGenerationError,
    MemberLostError,
    maybe_wrap_distributed,
)
from incubator_predictionio_tpu_torch.distributed.meshdir import MeshDirectory
from incubator_predictionio_tpu_torch.distributed.supervisor import (
    Supervisor,
    SupervisorResult,
)

__all__ = [
    "DistConfig",
    "DistContext",
    "DistSliceCheckpointer",
    "FencedGenerationError",
    "MemberLostError",
    "MeshDirectory",
    "Supervisor",
    "SupervisorResult",
    "maybe_wrap_distributed",
]
