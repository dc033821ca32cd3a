"""Model (de)serialization — the Kryo replacement.

Counterpart of ``incubator_predictionio_tpu/utils/serialization.py``: models
are pickled with a reducer that turns ``torch.Tensor`` leaves (the
reference turns ``jax.Array``) into numpy on the way out, so blobs are
host-independent and loading one never needs a card. Deploy moves to the
device what it serves (``prepare_for_serving``).
"""

from __future__ import annotations

import io
import pickle
from typing import Any

import numpy as np
import torch


class _TorchAwarePickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()  # numpy has no bfloat16; widening is exact
            return (np.asarray, (t.numpy(),))
        return NotImplemented


def serialize_model(obj: Any) -> bytes:
    buf = io.BytesIO()
    _TorchAwarePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def deserialize_model(data: bytes) -> Any:
    return pickle.loads(data)
