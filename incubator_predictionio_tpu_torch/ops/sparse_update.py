"""Fused gather→adam→scatter for sparse touched-row updates — kernel K3.

Counterpart of ``incubator_predictionio_tpu/ops/sparse_update.py``. The
streaming fold (``streaming/trainer.py``) updates only the embedding rows a
micro-batch names, in one stacked adam step:

- :func:`fused_adam_rows` — the host numpy engine, bitwise the per-row
  reference loop (``DeltaTrainer._adam``): every op elementwise IEEE fp32
  in the same order, per-row bias corrections from the scalar double
  ``b1 ** t`` (:func:`adam_bias_corrections`).
- :func:`fused_adam_rows_device` — the device engine: the micro-batch
  (rows, m, v, g and the bias corrections) is packed into one pinned host
  buffer that the module keeps, goes to the card in one asynchronous copy,
  kernel K3 (:func:`adam_rows`, ``csrc/sparse_update.cu``) runs the step,
  and one asynchronous copy brings rows, m and v back into pinned memory —
  where the reference runs its Pallas kernel on the TPU.
- :func:`fused_gather_adam_scatter` — the table-resident form: one copy of
  each table, then one launch of K3's indexed entry
  (:func:`adam_rows_indexed`), which reads the touched rows at ``idx`` and
  writes their new values into the copies (functional).

Beside K3 sits its plain PyTorch version (:func:`adam_rows_reference`:
separate elementwise ops, nothing fused; :func:`adam_rows_indexed_reference`
for the indexed entry). The wrappers take it only for CPU tensors; on CUDA
tensors they launch K3 or raise, and count their launches in
``adam_rows.launches``. K3 writes every step with round-to-nearest
intrinsics in the host's order, so it is meant to agree with
:func:`fused_adam_rows` bit for bit; the reference's own contract for its
compiled engines is fp32 roundoff (rtol 2e-5, atol 1e-7).

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

#: guards the launch counts and the device engine's staging buffers (held
#: across a whole device-engine call, which counts a launch inside it)
_LAUNCH_LOCK = threading.RLock()


def adam_bias_corrections(
    t: np.ndarray, b1: float = ADAM_B1, b2: float = ADAM_B2,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row ``(1 - b1**t, 1 - b2**t)`` as f32, computed with the scalar
    double ``**`` of the per-row reference — one pow per UNIQUE step
    count, never on the device — and spread to the rows by one gather."""
    uniq, inv = np.unique(np.asarray(t, np.int64), return_inverse=True)
    bc1 = np.array([1.0 - b1 ** int(tv) for tv in uniq], np.float32)
    bc2 = np.array([1.0 - b2 ** int(tv) for tv in uniq], np.float32)
    return bc1[inv.reshape(-1)], bc2[inv.reshape(-1)]


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


def _scalars(lr, b1, b2, eps) -> tuple:
    """The kernel's fp32 scalars as the host rounds them: lr, b1, 1 - b1,
    b2, 1 - b2, eps (the differences taken in double)."""
    return (float(lr), float(b1), float(1.0 - b1), float(b2),
            float(1.0 - b2), float(eps))


_F32 = (torch.float32,)


def _check_cuda(what: str, **tensors) -> None:
    """Each of ``tensors`` (name → (tensor, allowed dtypes)) is a contiguous
    CUDA tensor of an allowed dtype, all on one device; raises otherwise."""
    dev = None
    for name, (t, dtypes) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be a CUDA tensor, "
                             f"got one on {t.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: {name} must be "
                            f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if dev is not None and t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
        dev = t.device


def _count() -> None:
    with _LAUNCH_LOCK:
        adam_rows.launches += 1


def _launch_adam_rows(stack, bc, lr, b1, b2, eps):
    """Launch K3's stacked entry (``pio_adam_rows``) on CUDA tensors;
    raises on anything else."""
    what = "adam_rows"
    _check_cuda(what, stack=(stack, _F32), bc=(bc, _F32))
    r, d = _stack_shapes(stack, bc)
    out = torch.empty((3, r, d), dtype=torch.float32, device=stack.device)
    if r * d == 0:
        return out
    lib = _build.library("sparse_update")
    with torch.cuda.device(stack.device):
        stream = torch.cuda.current_stream(stack.device).cuda_stream
        err = lib.pio_adam_rows(stack.data_ptr(), bc.data_ptr(),
                                out.data_ptr(), r, d,
                                *_scalars(lr, b1, b2, eps), stream)
    _build.check(lib, err, what)
    _count()
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

#: the wrappers whose ``launches`` count kernel launches (K3's indexed
#: entry counts in ``adam_rows.launches`` too: one kernel, two entries)
KERNEL_WRAPPERS = (adam_rows,)


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for w in KERNEL_WRAPPERS:
            w.launches = 0


# -- K3's indexed entry: rows read and written in resident tables ------------------

def _indexed_shapes(tables, idx, g, bc1, bc2, out) -> tuple[int, int, int]:
    n, d = (int(x) for x in tables[0].shape)
    for name, t in (*zip(("table", "m_tab", "v_tab"), tables),
                    *zip(("table_out", "m_out", "v_out"), out)):
        if tuple(t.shape) != (n, d):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({n}, {d})")
    if idx.dim() != 1:
        raise ValueError(f"idx shape {tuple(idx.shape)} is not (R,)")
    r = int(idx.shape[0])
    if tuple(g.shape) != (r, d):
        raise ValueError(f"g shape {tuple(g.shape)} != ({r}, {d})")
    for name, t in (("bc1", bc1), ("bc2", bc2)):
        if tuple(t.shape) != (r,):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({r},)")
    return n, r, d


def adam_rows_indexed_reference(tables, idx, g, bc1, bc2, out, lr: float,
                                b1: float = ADAM_B1, b2: float = ADAM_B2,
                                eps: float = ADAM_EPS) -> None:
    """The plain PyTorch version of K3's indexed entry: gather the rows of
    ``tables`` (table, m, v) at ``idx``, :func:`adam_rows_reference`, and
    write the results at ``idx`` into ``out`` (three tables, in place)."""
    idx = idx.to(torch.int64)
    stack = torch.stack([t.index_select(0, idx) for t in tables]
                        + [g.to(torch.float32)])
    new = adam_rows_reference(stack, torch.stack([bc1, bc2]).float(),
                              lr, b1, b2, eps)
    for o, x in zip(out, new):
        o.index_copy_(0, idx, x)


def _launch_adam_rows_indexed(tables, idx, g, bc1, bc2, out, lr, b1, b2, eps):
    """Launch K3's indexed entry (``pio_adam_rows_indexed``) on CUDA
    tensors; raises on anything else."""
    what = "adam_rows_indexed"
    _check_cuda(what, table=(tables[0], _F32), m_tab=(tables[1], _F32),
                v_tab=(tables[2], _F32), table_out=(out[0], _F32),
                m_out=(out[1], _F32), v_out=(out[2], _F32),
                idx=(idx, (torch.int32, torch.int64)), g=(g, _F32),
                bc1=(bc1, _F32), bc2=(bc2, _F32))
    n, r, d = _indexed_shapes(tables, idx, g, bc1, bc2, out)
    if r * d == 0:
        return
    lib = _build.library("sparse_update")
    dev = idx.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pio_adam_rows_indexed(
            *(t.data_ptr() for t in tables), idx.data_ptr(),
            idx.element_size(), g.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
            *(t.data_ptr() for t in out), n, r, d,
            *_scalars(lr, b1, b2, eps), stream)
    _build.check(lib, err, what)
    _count()


def adam_rows_indexed(tables, idx: torch.Tensor, g: torch.Tensor,
                      bc1: torch.Tensor, bc2: torch.Tensor, out, lr: float,
                      b1: float = ADAM_B1, b2: float = ADAM_B2,
                      eps: float = ADAM_EPS) -> None:
    """One adam step over the rows ``idx`` (distinct, int32 or int64) of
    resident tables: ``tables`` = (table, m, v), each [N, D] f32, are read
    at ``idx``; ``g`` [R, D] and ``bc1``/``bc2`` [R] belong to the touched
    rows; the new rows, m and v are written at ``idx`` into ``out`` (three
    [N, D] f32 tables), which keep every other row as they are.

    K3's indexed entry on CUDA tensors (one launch, counted in
    ``adam_rows.launches``), its plain version on CPU tensors."""
    tensors = (*tables, idx, g, bc1, bc2, *out)
    if all(t.device.type == "cpu" for t in tensors):
        _indexed_shapes(tables, idx, g, bc1, bc2, out)
        adam_rows_indexed_reference(tables, idx, g, bc1, bc2, out, lr,
                                    b1, b2, eps)
        return
    _launch_adam_rows_indexed(tables, idx, g, bc1, bc2, out, lr, b1, b2, eps)


# -- the device engines -----------------------------------------------------------

class _Staging:
    """The device engine's buffers for one device, grown on demand and
    reused under ``_LAUNCH_LOCK``: ``up`` and ``down``, host f32 buffers
    (pinned for a CUDA device) with numpy views ``up_np``/``down_np``, and
    for a CUDA device ``dev``, one device f32 buffer for the micro-batch in
    and the rows, m and v out."""

    def __init__(self, dev: torch.device, n_up: int, n_down: int):
        pin = dev.type == "cuda"
        self.n_up, self.n_down = (1 << max(n - 1, 1).bit_length()
                                  for n in (n_up, n_down))
        self.up = torch.empty(self.n_up, dtype=torch.float32, pin_memory=pin)
        self.down = torch.empty(self.n_down, dtype=torch.float32,
                                pin_memory=pin)
        self.up_np, self.down_np = self.up.numpy(), self.down.numpy()
        self.dev = (torch.empty(self.n_up + self.n_down, dtype=torch.float32,
                                device=dev) if pin else None)


#: the device engine's staging by device (guarded by _LAUNCH_LOCK)
_STAGING: dict[torch.device, _Staging] = {}


def _staging(dev: torch.device, n_up: int, n_down: int) -> _Staging:
    st = _STAGING.get(dev)
    if st is None or st.n_up < n_up or st.n_down < n_down:
        st = _STAGING[dev] = _Staging(dev, n_up, n_down)
    return st


def _launch_adam_rows_staged(st: _Staging, r: int, d: int, lr, b1, b2,
                             eps) -> None:
    """K3's staged entry (``pio_adam_rows_staged``): ``st.up``'s packed
    micro-batch to the card, K3, the rows, m and v back into ``st.down``,
    and one wait for the stream — one call from the host."""
    dev = st.dev.device
    lib = _build.library("sparse_update")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        base = st.dev.data_ptr()
        err = lib.pio_adam_rows_staged(
            st.up.data_ptr(), base, base + 4 * st.n_up, st.down.data_ptr(),
            r, d, *_scalars(lr, b1, b2, eps), stream)
    _build.check(lib, err, "adam_rows_staged")
    _count()


def fused_adam_rows_device(
    rows: np.ndarray, m: np.ndarray, v: np.ndarray, g: np.ndarray,
    t: np.ndarray, lr: float,
    b1: float = ADAM_B1, b2: float = ADAM_B2, eps: float = ADAM_EPS,
    device: Union[str, torch.device, None] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The device twin of :func:`fused_adam_rows`: rows, m, v, g and the
    host-computed bias corrections are packed into one pinned host buffer
    that the module keeps (grown on demand), cross to ``device`` (CUDA
    unless the caller names another) in ONE asynchronous copy, run as one
    K3 launch, and come back in one asynchronous copy into pinned memory;
    one wait for the stream ends the call, and all four are one call into
    the kernel's library (``pio_adam_rows_staged``). On the CPU the same
    staging feeds K3's plain version."""
    dev = torch.device("cuda" if device is None else device)
    r, d = rows.shape
    n = r * d
    bc1, bc2 = adam_bias_corrections(t, b1, b2)
    with _LAUNCH_LOCK:
        st = _staging(dev, 4 * n + 2 * r, 3 * n)
        buf = st.up_np
        for j, a in enumerate((rows, m, v, g)):
            buf[j * n:(j + 1) * n] = np.asarray(a, np.float32).reshape(-1)
        buf[4 * n:4 * n + r] = bc1
        buf[4 * n + r:4 * n + 2 * r] = bc2
        if dev.type == "cuda":
            if n:
                _launch_adam_rows_staged(st, r, d, lr, b1, b2, eps)
        else:
            st.down[:3 * n] = adam_rows(
                st.up[:4 * n].view(4, r, d), st.up[4 * n:4 * n + 2 * r].view(2, r),
                lr, b1, b2, eps).view(-1)
        # a copy: the staging buffer is reused by the next call
        res = st.down_np[:3 * n].reshape(3, r, d).copy()
    return res[0], res[1], res[2]


def fused_gather_adam_scatter(
    table: torch.Tensor, m_tab: torch.Tensor, v_tab: torch.Tensor,
    idx: torch.Tensor, g: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
    *, lr: float, b1: float = ADAM_B1, b2: float = ADAM_B2,
    eps: float = ADAM_EPS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adam on the rows ``idx`` (distinct) of ``table/m_tab/v_tab``: one
    copy of each table, then one launch of K3's indexed entry (its plain
    version for CPU tensors) that reads the touched rows from the inputs
    and writes their new values into the copies. Returns the new ``(table,
    m_tab, v_tab)``; the inputs are never mutated. ``bc1``/``bc2`` are the
    per-row bias corrections from :func:`adam_bias_corrections`, so the
    double-precision ``b1 ** t`` stays the reference's."""
    tables = tuple(t.contiguous() for t in (table, m_tab, v_tab))
    out = tuple(t.clone() for t in tables)
    adam_rows_indexed(tables, idx, g.to(torch.float32).contiguous(),
                      bc1.to(torch.float32).contiguous(),
                      bc2.to(torch.float32).contiguous(), out, lr, b1, b2, eps)
    return out
