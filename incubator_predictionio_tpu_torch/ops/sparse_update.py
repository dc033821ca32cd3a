"""Fused gather→adam→scatter for sparse touched-row updates — kernel K3.

Counterpart of ``incubator_predictionio_tpu/ops/sparse_update.py``. The
streaming fold (``streaming/trainer.py``) updates only the embedding rows a
micro-batch names, in one stacked adam step:

- :func:`fused_adam_rows` — the host numpy engine, bitwise the per-row
  reference loop (``DeltaTrainer._adam``): every op elementwise IEEE fp32
  in the same order, per-row bias corrections from the scalar double
  ``b1 ** t`` (:func:`adam_bias_corrections`).
- :func:`fused_adam_rows_device` — the device engine: the whole micro-batch
  goes to the card in one copy (rows, m, v, g and the bias corrections in
  one buffer), kernel K3 (:func:`adam_rows`, ``csrc/sparse_update.cu``)
  runs the step, and one copy brings rows, m and v back — where the
  reference runs its Pallas kernel on the TPU.
- :func:`fused_gather_adam_scatter` — the table-resident form: a torch
  gather, K3, and an ``index_copy`` into clones of the tables (functional).

Beside K3 sits its plain PyTorch version (:func:`adam_rows_reference`:
separate elementwise ops, nothing fused). :func:`adam_rows` takes it only
for CPU tensors; on CUDA tensors it launches K3 or raises, and counts its
launches in ``adam_rows.launches``. K3 writes every step with
round-to-nearest intrinsics in the host's order, so it is meant to agree
with :func:`fused_adam_rows` bit for bit; the reference's own contract for
its compiled engines is fp32 roundoff (rtol 2e-5, atol 1e-7).

Unlike the reference, the device engine pads nothing: the TPU pads row
counts to blocks of 256 to bound its compiled executables, and a CUDA
kernel takes any ``R``.
"""

from __future__ import annotations

import threading
from typing import Union

import numpy as np
import torch

from incubator_predictionio_tpu_torch.ops import _build

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8

_LAUNCH_LOCK = threading.Lock()


def adam_bias_corrections(
    t: np.ndarray, b1: float = ADAM_B1, b2: float = ADAM_B2,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row ``(1 - b1**t, 1 - b2**t)`` as f32, computed with the scalar
    double ``**`` of the per-row reference — one pow per UNIQUE step
    count, never on the device."""
    t = np.asarray(t, np.int64)
    bc1 = np.empty(len(t), np.float32)
    bc2 = np.empty(len(t), np.float32)
    for tv in np.unique(t):
        sel = t == tv
        bc1[sel] = np.float32(1.0 - b1 ** int(tv))
        bc2[sel] = np.float32(1.0 - b2 ** int(tv))
    return bc1, bc2


def fused_adam_rows(
    rows: np.ndarray,        # [R, D] f32 current row values (will not mutate)
    m: np.ndarray,           # [R, D] f32 first moments
    v: np.ndarray,           # [R, D] f32 second moments
    g: np.ndarray,           # [R, D] f32 accumulated gradients
    t: np.ndarray,           # [R] int step counts AFTER this step (t >= 1)
    lr: float,
    b1: float = ADAM_B1, b2: float = ADAM_B2, eps: float = ADAM_EPS,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One vectorized adam step over a stacked touched-row batch in host
    numpy. Returns new ``(rows, m, v)``; op-for-op the per-row fp32 math."""
    bc1, bc2 = adam_bias_corrections(t, b1, b2)
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * (g * g)
    rows = rows - lr * (m / bc1[:, None]) / (
        np.sqrt(v / bc2[:, None]) + eps)
    return rows, m, v


# -- K3: the row-block adam step ------------------------------------------------

def _stack_shapes(stack: torch.Tensor, bc: torch.Tensor) -> tuple[int, int]:
    if stack.dim() != 3 or stack.shape[0] != 4:
        raise ValueError(f"stack shape {tuple(stack.shape)} != (4, R, D)")
    r, d = int(stack.shape[1]), int(stack.shape[2])
    if tuple(bc.shape) != (2, r):
        raise ValueError(f"bc shape {tuple(bc.shape)} != (2, {r})")
    return r, d


def adam_rows_reference(stack: torch.Tensor, bc: torch.Tensor, lr: float,
                        b1: float = ADAM_B1, b2: float = ADAM_B2,
                        eps: float = ADAM_EPS) -> torch.Tensor:
    """The plain PyTorch version of K3: ``stack`` [4, R, D] (rows, m, v, g),
    ``bc`` [2, R] (bc1, bc2) → [3, R, D] (rows, m, v). One op a step in the
    host pass's order (no ``addcmul`` or ``_foreach`` that could fuse).
    The square root is taken in float64 and rounded once to float32, which
    is the correctly rounded float32 root: PyTorch's vectorized float32
    ``sqrt`` on the CPU is not (it is ulps away from numpy's)."""
    rows, m, v, g = stack.unbind(0)
    bc1, bc2 = bc[0][:, None], bc[1][:, None]
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * (g * g)
    root = torch.sqrt((v2 / bc2).double()).float()
    rows2 = rows - lr * (m2 / bc1) / (root + eps)
    return torch.stack([rows2, m2, v2])


def _launch_adam_rows(stack, bc, lr, b1, b2, eps):
    """Launch K3 (``pio_adam_rows``) on CUDA tensors; raises on anything
    else."""
    what = "adam_rows"
    for name, t in (("stack", stack), ("bc", bc)):
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be a CUDA tensor, "
                             f"got one on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if stack.device != bc.device:
        raise ValueError(f"{what}: stack on {stack.device}, bc on {bc.device}")
    r, d = _stack_shapes(stack, bc)
    out = torch.empty((3, r, d), dtype=torch.float32, device=stack.device)
    if r * d == 0:
        return out
    lib = _build.library("sparse_update")
    with torch.cuda.device(stack.device):
        stream = torch.cuda.current_stream(stack.device).cuda_stream
        err = lib.pio_adam_rows(
            stack.data_ptr(), bc.data_ptr(), out.data_ptr(), r, d,
            float(lr), float(b1), float(1.0 - b1), float(b2),
            float(1.0 - b2), float(eps), stream)
    _build.check(lib, err, what)
    with _LAUNCH_LOCK:
        adam_rows.launches += 1
    return out


def adam_rows(stack: torch.Tensor, bc: torch.Tensor, lr: float,
              b1: float = ADAM_B1, b2: float = ADAM_B2,
              eps: float = ADAM_EPS) -> torch.Tensor:
    """One adam step over stacked rows: ``stack`` [4, R, D] f32 (rows, m,
    v, g), ``bc`` [2, R] f32 (per-row bias corrections) → [3, R, D] f32
    (rows, m, v).

    K3 on CUDA tensors, its plain version on CPU tensors."""
    if stack.device.type == "cpu" and bc.device.type == "cpu":
        _stack_shapes(stack, bc)
        return adam_rows_reference(stack, bc, lr, b1, b2, eps)
    return _launch_adam_rows(stack, bc, lr, b1, b2, eps)


adam_rows.launches = 0

#: the wrappers whose ``launches`` count kernel launches
KERNEL_WRAPPERS = (adam_rows,)


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for w in KERNEL_WRAPPERS:
            w.launches = 0


# -- the device engines -----------------------------------------------------------

def fused_adam_rows_device(
    rows: np.ndarray, m: np.ndarray, v: np.ndarray, g: np.ndarray,
    t: np.ndarray, lr: float,
    b1: float = ADAM_B1, b2: float = ADAM_B2, eps: float = ADAM_EPS,
    device: Union[str, torch.device, None] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The device twin of :func:`fused_adam_rows`: the micro-batch crosses
    to ``device`` (CUDA unless the caller names another) in ONE copy — rows,
    m, v, g and the host-computed bias corrections packed in one buffer —
    runs as one K3 launch (its plain version on the CPU), and comes back in
    one copy."""
    dev = torch.device("cuda" if device is None else device)
    r, d = rows.shape
    n = r * d
    bc1, bc2 = adam_bias_corrections(t, b1, b2)
    buf = np.empty(4 * n + 2 * r, np.float32)
    for j, a in enumerate((rows, m, v, g)):
        buf[j * n:(j + 1) * n] = np.asarray(a, np.float32).reshape(-1)
    buf[4 * n:4 * n + r] = bc1
    buf[4 * n + r:] = bc2
    packed = torch.from_numpy(buf).to(dev)
    out = adam_rows(packed[:4 * n].view(4, r, d),
                    packed[4 * n:].view(2, r), lr, b1, b2, eps)
    out = out.cpu().numpy()
    return out[0], out[1], out[2]


def fused_gather_adam_scatter(
    table: torch.Tensor, m_tab: torch.Tensor, v_tab: torch.Tensor,
    idx: torch.Tensor, g: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
    *, lr: float, b1: float = ADAM_B1, b2: float = ADAM_B2,
    eps: float = ADAM_EPS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather ``table/m/v`` rows at ``idx`` (distinct rows), run K3 on them
    (its plain version for CPU tensors), scatter the results into clones of
    the tables. Returns new ``(table, m_tab, v_tab)``; the inputs are never
    mutated. ``bc1``/``bc2`` are the per-row bias corrections from
    :func:`adam_bias_corrections`, so the double-precision ``b1 ** t``
    stays the reference's."""
    idx = idx.to(torch.int64)
    stack = torch.stack([table[idx], m_tab[idx], v_tab[idx],
                         g.to(torch.float32)]).contiguous()
    bc = torch.stack([bc1, bc2]).to(torch.float32).contiguous()
    out = adam_rows(stack, bc, lr, b1, b2, eps)
    return (table.clone().index_copy_(0, idx, out[0]),
            m_tab.clone().index_copy_(0, idx, out[1]),
            v_tab.clone().index_copy_(0, idx, out[2]))
