"""The port's two adams: optax's (the sequential trainer) and the dense
adam of the two-tower trainer.

**optax's adam** (:func:`adam_init`, :func:`adam_update`). Counterpart of the optimizer the reference's transformer trains with
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

**The two-tower trainer's adam** (:func:`adam_tree_init`,
:func:`adam_apply`). Counterpart of ``incubator_predictionio_tpu/utils/
optim.py`` ``adam_tree_init`` (:81) and ``adam_apply`` (:88-117): BOTH
moments are stored in ``adam_moments_dtype`` (fp32 or bf16) and all the
arithmetic is fp32, in the reference's order:

- ``m32 = b1·m.float() + (1-b1)·g`` and ``v32 = b2·v.float() + (1-b2)·g²``;
- ``p - lr·(m32/bc1) / (sqrt(v32/bc2) + eps)``, with ``bc = 1 - b^t``;
- then ``m32`` and ``v32`` are stored, rounded to nearest even.

This is not :func:`adam_update`: there ``b1·mu`` is a bf16 product and
``nu`` is always fp32. The update runs in place over every row of the
tables (the adam is dense: ``m`` decays where the gradient is zero), with
``_foreach_*_`` ops on the tables and table-sized scratch buffers the
state keeps, so no step allocates a new table.
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


def _sqrt_(tensors: list) -> None:
    """In place, the square root of each tensor, correctly rounded and the
    same every run: ``torch._foreach_sqrt_`` on the card, numpy's on the
    CPU. PyTorch's float32 ``sqrt`` on the CPU is not correctly rounded,
    and under load a worker thread's first call in a process can return a
    ~12-bit approximation for its chunk of the tensor (thousands of ulps
    off; ``launch_ab.py --cpu-repeats``), so two fits from the same inputs
    could differ."""
    on_card = [t for t in tensors if t.device.type != "cpu"]
    if on_card:
        torch._foreach_sqrt_(on_card)
    for t in tensors:
        if t.device.type == "cpu":
            a = t.numpy()
            np.sqrt(a, out=a)


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
    _sqrt_(den)
    torch._foreach_add_(den, EPS)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(params, upd)
    for stored, new in zip(state.mu, mu):
        stored.copy_(new)  # rounds to bf16 (nearest even) when mu is bf16
    state.nu = nu


@dataclasses.dataclass
class AdamTreeState:
    """The reference's ``(count, m, v)``: the step count (on the host, so
    the bias corrections cost no device sync) and both moments in their
    storage dtype. ``scratch`` holds the fp32 buffers :func:`adam_apply`
    works in, made at the first step and kept."""

    count: int
    m: list
    v: list
    # not checkpointed (utils/checkpoint.py): rebuilt at the first step
    scratch: list = dataclasses.field(default_factory=list,
                                      metadata={"checkpoint": False})


def adam_tree_init(params, moments_dtype: str = "float32") -> AdamTreeState:
    """Zero moments beside ``params`` (a list of fp32 tensors), both in
    ``moments_dtype``."""
    dt = _mu_dtype(moments_dtype)
    return AdamTreeState(0, [torch.zeros_like(p, dtype=dt) for p in params],
                         [torch.zeros_like(p, dtype=dt) for p in params])


@torch.no_grad()
def adam_apply(params, grads, state: AdamTreeState, lr: float,
               b1: float = B1, b2: float = B2, eps: float = EPS) -> None:
    """One step of the reference's ``adam_apply``, in place on ``params``
    and ``state``. ``grads`` is consumed: its tensors are overwritten."""
    params, grads = list(params), list(grads)
    state.count += 1
    t = np.float32(state.count)
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    fp32 = state.m[0].dtype == torch.float32
    if not state.scratch:
        n = 1 if fp32 else 2
        state.scratch = [[torch.empty_like(p) for p in params] for _ in range(n)]
    s = state.scratch[0]
    # v32 = b2·v + (1-b2)·(g·g), into v itself (fp32) or into s (bf16)
    v32 = state.v if fp32 else s
    if not fp32:
        torch._foreach_copy_(v32, state.v)
    torch._foreach_mul_(v32, b2)
    w = state.scratch[-1] if not fp32 else s
    torch._foreach_copy_(w, grads)
    torch._foreach_mul_(w, grads)
    torch._foreach_mul_(w, 1.0 - b2)
    torch._foreach_add_(v32, w)
    if not fp32:
        torch._foreach_copy_(state.v, v32)  # rounds to nearest even
    # m32 = b1·m + (1-b1)·g, into m (fp32) or into w (bf16)
    m32 = state.m if fp32 else w
    if not fp32:
        torch._foreach_copy_(m32, state.m)
    torch._foreach_mul_(m32, b1)
    torch._foreach_mul_(grads, 1.0 - b1)
    torch._foreach_add_(m32, grads)
    if not fp32:
        torch._foreach_copy_(state.m, m32)
    # p - lr·(m32/bc1) / (sqrt(v32/bc2) + eps); the grads hold the
    # denominator, the scratch the step
    step = s if fp32 else w
    if fp32:
        torch._foreach_copy_(step, m32)
    torch._foreach_div_(step, bc1)
    torch._foreach_mul_(step, lr)
    torch._foreach_copy_(grads, v32)
    torch._foreach_div_(grads, bc2)
    _sqrt_(grads)
    torch._foreach_add_(grads, eps)
    torch._foreach_div_(step, grads)
    torch._foreach_sub_(params, step)
