"""DeviceContext — the execution context handed to the serving stages.

Counterpart of ``incubator_predictionio_tpu/parallel/mesh.py:MeshContext``,
cut to the surface the deploy, query and single-device training paths use
(``is_primary``, ``device``, ``process_count``, ``pad_to_batch_multiple``,
``create()``). Where the reference owns a ``jax.sharding.Mesh``, this port
owns one ``torch.device``: the card the tables and the model live on.
Multi-process meshes come with the sharding slice (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class DeviceContext:
    """One device plus the process coordinates of the run."""

    device: torch.device
    process_index: int = 0  # multi-process runs come with the sharding slice
    process_count: int = 1

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0

    def pad_to_batch_multiple(self, n: int) -> int:
        """mesh.py:271: the smallest multiple of the data axis ≥ n. One
        device is a data axis of size 1, so ``n`` itself."""
        return n

    @staticmethod
    def create(device: Optional[Union[str, torch.device]] = None
               ) -> "DeviceContext":
        """``cuda:0`` unless the caller names another device. Raises when
        CUDA is asked for (explicitly or by default) and absent: the port
        never falls back to the CPU on its own — pass ``device="cpu"`` to
        run there, as the CPU tests do."""
        dev = torch.device("cuda:0" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"DeviceContext: {dev} requested but CUDA is not available "
                "(pass device='cpu' to run on the CPU)")
        return DeviceContext(dev)
