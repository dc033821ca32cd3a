"""Quantized full-catalog retrieval scoring — hand-written CUDA kernels.

Counterpart of ``incubator_predictionio_tpu/ops/retrieval.py``. The serving
hot path scores a user batch against the whole int8 row-quantized catalog,
``scores[B, N] = (bf16(q) · items_q[N, D]ᵀ) * scale + bias + mask`` (K1,
:func:`score_catalog_quantized`), and the IVF coarse stage scores int8
queries against int8 centroids with an exact int32 accumulator (K2,
:func:`score_centroids_quantized`). Both kernels live in
``csrc/retrieval.cu`` (built by :mod:`._build`); the note there says what
bounds them on an H100.

Beside each kernel sits its plain PyTorch version
(:func:`score_catalog_reference`, :func:`score_centroids_reference`). The
public wrappers take the plain version only for tensors on the CPU; given
CUDA tensors they launch the kernel or raise. Each wrapper counts its kernel
launches in a plain integer attribute, ``launches``.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from incubator_predictionio_tpu_torch.ops import _build

ITEM_BLOCK = 512  # catalog rows per block of the reference's grid; N pads to it

#: Widest rank for which int8×int8 products summed over a row fit a float32
#: mantissa EXACTLY: every partial product is ≤ 127² = 16129, so a D-dim dot
#: is ≤ 127²·D < 2²⁴ for D ≤ 1040 — f32 BLAS over the int8-valued operands
#: computes the int32 accumulation bit-exactly.
INT8_EXACT_MAX_RANK = (1 << 24) // (127 * 127)

#: Widest rank the K1 kernel takes: it is built for up to 16 K steps of 16
#: dims (a step's catalog words stay in registers), and at 256 the bf16
#: query fragments of 128 queries (64 KB) still stage once a block beside
#: its catalog ring, so every batch up to 128 reads the catalog once.
KERNEL_MAX_RANK = 256

_LAUNCH_LOCK = threading.Lock()


def quantize_rows(items: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization: returns (int8 rows, fp32 scales)."""
    amax = np.abs(items).max(axis=1, keepdims=True)
    scale = (amax / 127.0 + 1e-12).astype(np.float32)
    q = np.clip(np.round(items / scale), -127, 127).astype(np.int8)
    return q, scale[:, 0]


def quantize_catalog_device(
    item_emb: torch.Tensor, item_bias: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`quantize_rows` + :func:`pad_catalog` in torch, on the tensors'
    device — deploy quantizes the catalog on the card. Returns
    ``(items_q, scales, bias, mask)`` padded to the :data:`ITEM_BLOCK`
    multiple (padding masked with -inf). ``torch.round`` rounds half to
    even like ``np.round``/``jnp.round``, so the result is bitwise the
    host's."""
    n, d = item_emb.shape
    item_emb = item_emb.float()
    dev = item_emb.device
    amax = item_emb.abs().amax(dim=1, keepdim=True)
    # divide by a tensor on the same device: PyTorch's CUDA division by a
    # host scalar multiplies by its reciprocal, which can move the last bit
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(item_emb / scale), -127, 127).to(torch.int8)
    pad = (-n) % ITEM_BLOCK
    mask = torch.zeros(n + pad, dtype=torch.float32, device=dev)
    mask[n:] = -torch.inf
    return (
        torch.cat([q, torch.zeros((pad, d), dtype=torch.int8, device=dev)]),
        torch.cat([scale[:, 0], torch.zeros(pad, device=dev)]),
        torch.cat([item_bias.float(), torch.zeros(pad, device=dev)]),
        mask,
    )


def pad_centroids(cent_q: np.ndarray, cent_scales: np.ndarray,
                  cent_bias: np.ndarray, block: int = ITEM_BLOCK):
    """Pad the quantized centroid table to the kernel block multiple.
    Padded rows carry zero embeddings/scales and **-inf bias**, so they can
    never win a probe slot."""
    c = cent_q.shape[0]
    pad = (-c) % block
    if not pad:
        return cent_q, cent_scales, cent_bias
    return (
        np.concatenate([cent_q, np.zeros((pad, cent_q.shape[1]), np.int8)]),
        np.concatenate([cent_scales, np.zeros(pad, np.float32)]),
        np.concatenate([cent_bias, np.full(pad, -np.inf, np.float32)]),
    )


def pad_catalog(items_q: np.ndarray, *vectors: np.ndarray,
                block: int = ITEM_BLOCK):
    """Pad catalog rows to the block multiple; padded mask rows get -inf."""
    n = items_q.shape[0]
    n_pad = ((n + block - 1) // block) * block
    if n_pad == n:
        return (items_q, *vectors)
    pad = n_pad - n
    out = [np.concatenate([items_q, np.zeros((pad, items_q.shape[1]), items_q.dtype)])]
    for i, v in enumerate(vectors):
        fill = -np.inf if i == len(vectors) - 1 else 0.0  # last vector = mask
        out.append(np.concatenate([v, np.full(pad, fill, v.dtype)]))
    return tuple(out)


def int8_matmul_exact(a_q: np.ndarray, b_q: np.ndarray) -> np.ndarray:
    """Exact ``a_q [M, D] int8 @ b_q [N, D] int8 ᵀ → [M, N]`` accumulation on
    host, returned as f32 holding exact integer values (f64 past
    :data:`INT8_EXACT_MAX_RANK`)."""
    d = a_q.shape[1]
    acc_dtype = np.float32 if d <= INT8_EXACT_MAX_RANK else np.float64
    out = a_q.astype(acc_dtype) @ b_q.astype(acc_dtype).T
    return out.astype(np.float32, copy=False)


# -- shared argument checks --------------------------------------------------

def _on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    """True when every given tensor lies on the CPU, False when all lie on
    one CUDA device; raises on a mix."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    return next(iter(devs)).type == "cpu"


def _check_cuda(what: str, **tensors) -> None:
    for name, (t, dtype) in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be a CUDA tensor, "
                             f"got one on {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _count(wrapper) -> None:
    with _LAUNCH_LOCK:
        wrapper.launches += 1


# -- K1: catalog scorer --------------------------------------------------------

def _catalog_shapes(q, items_q, scales, bias, mask, row_mask):
    b, d = q.shape
    n = items_q.shape[0]
    if n % ITEM_BLOCK:
        raise ValueError(f"catalog rows ({n}) must be padded to {ITEM_BLOCK}")
    if items_q.shape[1] != d:
        raise ValueError(f"items width {items_q.shape[1]} != query width {d}")
    for name, v in (("scales", scales), ("bias", bias), ("mask", mask)):
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name} shape {tuple(v.shape)} != ({n},)")
    if row_mask is not None and tuple(row_mask.shape) != (b, n):
        raise ValueError(
            f"row_mask shape {tuple(row_mask.shape)} != (batch, catalog) {(b, n)}")
    return b, n, d


def score_catalog_reference(q, items_q, scales, bias, mask, row_mask=None):
    """The plain PyTorch version of K1: ``bf16(q) @ float(items_q)ᵀ`` summed
    in fp32 (the products are exact), then the epilogue in the reference's
    order. The CPU path and the test oracle."""
    qf = q.to(torch.bfloat16).float()
    scores = qf @ items_q.float().T
    scores = scores * scales[None, :] + bias[None, :] + mask[None, :]
    if row_mask is not None:
        scores = scores + row_mask
    return scores


def _launch_score_catalog(q, items_q, scales, bias, mask, row_mask=None):
    """Launch K1 (``pio_score_catalog``) on CUDA tensors; raises on anything
    else."""
    what = "score_catalog_quantized"
    _check_cuda(what, q=(q, torch.float32), items_q=(items_q, torch.int8),
                scales=(scales, torch.float32), bias=(bias, torch.float32),
                mask=(mask, torch.float32),
                row_mask=(row_mask, torch.float32))
    _on_cpu(q, items_q, scales, bias, mask, row_mask)  # one device
    b, n, d = _catalog_shapes(q, items_q, scales, bias, mask, row_mask)
    if d > KERNEL_MAX_RANK:
        raise ValueError(f"{what}: rank {d} > {KERNEL_MAX_RANK}")
    if d % 16 == 0 and items_q.data_ptr() % 16:
        raise ValueError(f"{what}: items_q must be 16-byte aligned")
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    lib = _build.library("retrieval")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pio_score_catalog(
            _ptr(q), _ptr(items_q), _ptr(scales), _ptr(bias), _ptr(mask),
            _ptr(row_mask), _ptr(out), b, n, d, stream)
    _build.check(lib, err, what)
    _count(score_catalog_quantized)
    return out


def score_catalog_quantized(q, items_q, scales, bias, mask, row_mask=None):
    """q [B, D] fp32; items_q [N, D] int8; scales/bias/mask [N] fp32;
    optional row_mask [B, N] fp32 (per-query -inf filters) → [B, N] fp32.

    K1 on CUDA tensors, its plain version on CPU tensors."""
    if _on_cpu(q, items_q, scales, bias, mask, row_mask):
        _catalog_shapes(q, items_q, scales, bias, mask, row_mask)
        return score_catalog_reference(q, items_q, scales, bias, mask, row_mask)
    return _launch_score_catalog(q, items_q, scales, bias, mask, row_mask)


score_catalog_quantized.launches = 0


# -- K2: int8 coarse stage (centroid scoring) ----------------------------------

def _centroid_shapes(q_q, q_scales, cent_q, cent_scales, cent_bias):
    b, d = q_q.shape
    c = cent_q.shape[0]
    if c % ITEM_BLOCK:
        raise ValueError(f"centroid rows ({c}) must be padded to {ITEM_BLOCK}")
    if cent_q.shape[1] != d:
        raise ValueError(f"centroid width {cent_q.shape[1]} != query width {d}")
    if tuple(q_scales.shape) != (b,):
        raise ValueError(f"q_scales shape {tuple(q_scales.shape)} != ({b},)")
    for name, v in (("cent_scales", cent_scales), ("cent_bias", cent_bias)):
        if tuple(v.shape) != (c,):
            raise ValueError(f"{name} shape {tuple(v.shape)} != ({c},)")
    return b, c, d


def score_centroids_reference(q_q, q_scales, cent_q, cent_scales, cent_bias):
    """The plain PyTorch version of K2: fp32 products of int8-valued
    operands — exact integers for D ≤ :data:`INT8_EXACT_MAX_RANK` (float64
    past it) — then one rescale and the bias, in the reference's order."""
    acc_dtype = (torch.float32 if q_q.shape[1] <= INT8_EXACT_MAX_RANK
                 else torch.float64)
    acc = (q_q.to(acc_dtype) @ cent_q.to(acc_dtype).T).float()
    return (acc * (q_scales[:, None] * cent_scales[None, :])
            + cent_bias[None, :])


def _launch_score_centroids(q_q, q_scales, cent_q, cent_scales, cent_bias):
    """Launch K2 (``pio_score_centroids``) on CUDA tensors; raises on
    anything else."""
    what = "score_centroids_quantized"
    _check_cuda(what, q_q=(q_q, torch.int8), q_scales=(q_scales, torch.float32),
                cent_q=(cent_q, torch.int8),
                cent_scales=(cent_scales, torch.float32),
                cent_bias=(cent_bias, torch.float32))
    _on_cpu(q_q, q_scales, cent_q, cent_scales, cent_bias)  # one device
    b, c, d = _centroid_shapes(q_q, q_scales, cent_q, cent_scales, cent_bias)
    if d > INT8_EXACT_MAX_RANK:
        raise ValueError(f"{what}: rank {d} > {INT8_EXACT_MAX_RANK}")
    out = torch.empty((b, c), dtype=torch.float32, device=q_q.device)
    if b == 0:
        return out
    lib = _build.library("retrieval")
    with torch.cuda.device(q_q.device):
        stream = torch.cuda.current_stream(q_q.device).cuda_stream
        err = lib.pio_score_centroids(
            _ptr(q_q), _ptr(q_scales), _ptr(cent_q), _ptr(cent_scales),
            _ptr(cent_bias), _ptr(out), b, c, d, stream)
    _build.check(lib, err, what)
    _count(score_centroids_quantized)
    return out


def score_centroids_quantized(q_q, q_scales, cent_q, cent_scales, cent_bias):
    """q_q [B, D] int8; q_scales [B] f32; cent_q [C, D] int8;
    cent_scales/cent_bias [C] f32 → [B, C] f32 coarse scores. ``C`` must be
    padded to the :data:`ITEM_BLOCK` multiple (:func:`pad_centroids`).

    K2 on CUDA tensors, its plain version on CPU tensors."""
    if _on_cpu(q_q, q_scales, cent_q, cent_scales, cent_bias):
        _centroid_shapes(q_q, q_scales, cent_q, cent_scales, cent_bias)
        return score_centroids_reference(
            q_q, q_scales, cent_q, cent_scales, cent_bias)
    return _launch_score_centroids(q_q, q_scales, cent_q, cent_scales, cent_bias)


score_centroids_quantized.launches = 0


def probe_bucket(b: int) -> int:
    """The coarse probe's batch bucket: the next power of two, at least 8
    (the reference's ``_probe_tpu`` buckets)."""
    return 1 << max(3, (b - 1).bit_length())


def _probe_layout(bp: int, d: int) -> tuple[int, int]:
    """(byte offset of the scales, total bytes) of a packed probe batch:
    the [bp, D] int8 queries, padded to 16 bytes, then [bp] fp32 scales."""
    off = -(-bp * d // 16) * 16
    return off, off + 4 * bp


def probe_packed_bytes(b: int, d: int) -> int:
    """Bytes of a batch of ``b`` queries of width ``d`` packed by
    :func:`pack_probe_queries`."""
    return _probe_layout(probe_bucket(b), d)[1]


def pack_probe_queries(q_q: np.ndarray, q_scales: np.ndarray,
                       out: torch.Tensor) -> torch.Tensor:
    """Pad a probe batch (``q_q`` [B, D] int8, ``q_scales`` [B] f32) to its
    :func:`probe_bucket` with zero rows and zero scales and pack both into
    ``out``, a uint8 host buffer of at least :func:`probe_packed_bytes`
    (pinned for a fast copy), so that the batch crosses to the card in one
    copy; returns the packed bytes (a view of ``out``).
    :func:`unpack_probe_queries` gives the two tensors back."""
    b, d = q_q.shape
    bp = probe_bucket(b)
    off, size = _probe_layout(bp, d)
    buf = out[:size].numpy()
    qq = buf[:bp * d].view(np.int8).reshape(bp, d)
    qq[:b] = q_q
    qq[b:] = 0
    qs = buf[off:size].view(np.float32)
    qs[:b] = q_scales
    qs[b:] = 0.0
    return out[:size]


def unpack_probe_queries(packed: torch.Tensor, b: int,
                         d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The padded ``(q_q [bp, D] int8, q_scales [bp] f32)`` of a batch of
    ``b`` queries packed by :func:`pack_probe_queries`, as views of
    ``packed`` (on whichever device it lies)."""
    bp = probe_bucket(b)
    off, size = _probe_layout(bp, d)
    return (packed[:bp * d].view(torch.int8).view(bp, d),
            packed[off:size].view(torch.float32))

#: the wrappers whose ``launches`` count kernel launches
KERNEL_WRAPPERS = (score_catalog_quantized, score_centroids_quantized)


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for w in KERNEL_WRAPPERS:
            w.launches = 0
