"""Adam of the sequential trainer — ``optax.adam(lr, mu_dtype=...)``.

Counterpart of the optimizer the reference's transformer trains with
(``incubator_predictionio_tpu/models/transformer.py:275-283``, its state made
by ``utils/optim.py:jit_adam_init``): the state is ``(count, mu, nu)`` over
the parameters; ``mu`` is stored in fp32 or, with ``adam_moments_dtype=
"bfloat16"``, in bf16; ``nu`` is always fp32. The update is optax's
``scale_by_adam`` in fp32, in its order of operations:

- ``mu = (1-b1)·g + b1·mu`` — with a bf16 ``mu``, ``b1·mu`` is a bf16
  product (JAX's weak typing rounds ``b1`` to bf16 and the product to
  bf16), then the sum is fp32;
- ``nu = (1-b2)·g² + b2·nu``;
- ``p += -lr · (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps)``, with the
  fp32 ``mu``, which is rounded to its stored dtype (round to nearest
  even) only afterwards.

(``torch.optim.Adam`` cannot store ``mu`` in bf16, and it orders the
arithmetic otherwise.) The lists of tensors are updated in place with
``torch._foreach_*`` ops: a handful of launches a step for the whole model.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def _mu_dtype(moments_dtype: str) -> torch.dtype:
    if moments_dtype == "bfloat16":
        return torch.bfloat16
    if moments_dtype == "float32":
        return torch.float32
    raise ValueError(f"adam_moments_dtype must be 'float32' or 'bfloat16', "
                     f"got {moments_dtype!r}")


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count (kept on the host, so
    that the bias corrections cost no device sync), ``mu`` and ``nu``."""

    count: int
    mu: list
    nu: list


def adam_init(params, moments_dtype: str = "float32") -> AdamState:
    """Zero moments beside ``params`` (a list of fp32 tensors): ``mu`` in
    ``moments_dtype``, ``nu`` in fp32."""
    dt = _mu_dtype(moments_dtype)
    return AdamState(0, [torch.zeros_like(p, dtype=dt) for p in params],
                     [torch.zeros_like(p, dtype=torch.float32) for p in params])


@torch.no_grad()
def adam_update(params, grads, state: AdamState, lr: float) -> None:
    """One ``optax.adam`` step (b1 :data:`B1`, b2 :data:`B2`, eps
    :data:`EPS`), in place on ``params`` and ``state``."""
    state.count += 1
    t = np.float32(state.count)
    # 1 - decay**count in fp32, as optax's bias_correction computes it
    bc1 = float(np.float32(1) - np.float32(B1) ** t)
    bc2 = float(np.float32(1) - np.float32(B2) ** t)
    grads = list(grads)
    if state.mu[0].dtype == torch.bfloat16:
        # b1 · mu in bf16: the weakly typed b1 becomes a bf16 scalar
        b1_mu = torch._foreach_mul(state.mu, float(torch.tensor(B1).to(torch.bfloat16)))
        b1_mu = [x.float() for x in b1_mu]
    else:
        b1_mu = torch._foreach_mul(state.mu, B1)
    mu = torch._foreach_mul(grads, 1 - B1)
    torch._foreach_add_(mu, b1_mu)
    nu = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(nu, 1 - B2)
    torch._foreach_add_(nu, torch._foreach_mul(state.nu, B2))
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, EPS)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(params, upd)
    for stored, new in zip(state.mu, mu):
        stored.copy_(new)  # rounds to bf16 (nearest even) when mu is bf16
    state.nu = nu
