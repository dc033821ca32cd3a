"""Causal multi-head attention of the sequential recommender — hand-written
CUDA kernels.

Counterpart of ``incubator_predictionio_tpu/ops/attention.py`` (K4, the
small-head kernel) and of the library flash kernel that
``incubator_predictionio_tpu/parallel/ring.py:causal_attention`` calls for
long sequences (K5). Both take the reference kernels' layout: q, k, v
``[B, H, L, D]`` bf16 in, ``[B, H, L, D]`` bf16 out, scale ``1/sqrt(D)``.

- :func:`causal_mha_small_head` (K4) normalises ``p = exp(s - m) / l`` in
  fp32 before rounding it to bf16 for the PV product, as the TPU kernel does
  with its whole ``[L, L]`` block. Its CUDA counterpart gets there in two
  passes over the key tiles (statistics, then output).
- :func:`flash_causal_attention` (K5) is one pass of online softmax: a
  running max and sum, an fp32 accumulator rescaled as the max moves, ``p``
  rounded to bf16 before PV and one division by the row sum at the end.

Both kernels live in ``csrc/attention.cu`` (built by :mod:`._build`); the
note there says what bounds them on an H100. Beside each sits its plain
PyTorch version (:func:`causal_mha_small_head_reference`,
:func:`flash_causal_attention_reference`). The wrappers take the plain
version only for tensors on the CPU; given CUDA tensors they launch the
kernel or raise. Each wrapper counts its launches in ``launches``.
"""

from __future__ import annotations

import math

import torch

from incubator_predictionio_tpu_torch.ops import _build
from incubator_predictionio_tpu_torch.ops.retrieval import (
    _check_cuda,
    _count,
    _LAUNCH_LOCK,
    _on_cpu,
    _ptr,
)

#: query rows (and key columns) per tile of the CUDA kernels; L must be a
#: multiple of it
TILE = 64
#: head widths the kernels are instantiated for
HEAD_DIMS = (32, 64, 128)


def fits_small_head_kernel(b: int, l: int, h: int, d: int) -> bool:
    """Copy of ``incubator_predictionio_tpu/ops/attention.py:fits_small_head_kernel``
    (:37): the shapes the reference routes to its small-head kernel. The
    budget is the TPU kernel's VMEM (its backward: 7 ``[1, H, L, D]`` bf16
    blocks plus ~4 ``[L, L]`` fp32 per-head intermediates, under 12 MB);
    the port routes on the same predicate so that both packages run the
    same arithmetic at the same shapes."""
    if l % 128 or d % 64 or l < 128:
        return False
    vmem_bytes = 7 * h * l * d * 2 + 4 * l * l * 4
    return vmem_bytes <= 12 * 1024 * 1024


# -- plain versions ------------------------------------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q·kᵀ · scale`` in fp32 over bf16 operands (products of bf16 values
    are exact in fp32), causal positions above the diagonal at -inf."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    l = q.shape[-2]
    upper = torch.ones(l, l, dtype=torch.bool, device=q.device).triu(1)
    return s.masked_fill(upper, -torch.inf)


def causal_mha_small_head_reference(q, k, v):
    """The plain PyTorch version of K4, in the TPU kernel's order (its
    ``_fwd_kernel``): fp32 scores, ``p = exp(s - max) / sum`` in fp32,
    ``p`` rounded to bf16, ``p·v`` summed in fp32, the output in bf16."""
    s = _scores(q, k)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(torch.bfloat16).float(), v.float())
    return o.to(q.dtype)


def flash_causal_attention_reference(q, k, v, block: int):
    """The plain PyTorch version of K5: online softmax over key blocks of
    ``block`` columns, as the library flash kernel walks them — a running
    max ``m`` and sum ``l`` in fp32, the accumulator rescaled by
    ``exp(m_old - m_new)``, ``p`` rounded to bf16 before PV, and one
    division by ``l`` at the end. (The CUDA kernel walks the same keys in
    :data:`TILE`-wide tiles; in exact arithmetic the two agree, and in fp32
    they differ by the bf16 rounding of ``p`` against another running max.)
    """
    s_all = _scores(q, k)
    l_seq = q.shape[-2]
    m = torch.full(q.shape[:-1], -torch.inf, device=q.device)
    den = torch.zeros(q.shape[:-1], device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    vf = v.float()
    for k0 in range(0, l_seq, block):
        s = s_all[..., k0:k0 + block]
        # every row sees key 0 in the first block, so m_new is finite and
        # the first alpha is exp(-inf) = 0
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        den = den * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(torch.bfloat16).float(), vf[..., k0:k0 + block, :])
        m = m_new
    return (acc / den[..., None]).to(q.dtype)


# -- wrappers ------------------------------------------------------------------

def _check(what: str, q, k, v) -> tuple[int, int, int, int]:
    """The kernels' contract, enforced on every device so that a CPU run
    refuses what the card would: q, k, v ``[B, H, L, D]`` of one shape,
    bf16, contiguous, D in :data:`HEAD_DIMS`, L a multiple of
    :data:`TILE`."""
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be [B, H, L, D], got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != "
                             f"q shape {tuple(q.shape)}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: {name} must be torch.bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    b, h, l, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {HEAD_DIMS}")
    if l % TILE:
        raise ValueError(f"{what}: sequence length {l} is not a multiple "
                         f"of the {TILE}-row tile")
    return b, h, l, d


def _launch(what: str, fn_name: str, wrapper, q, k, v):
    """Launch one of the attention kernels on q's current stream and count
    the launch. Raises on anything the kernel does not take, a CPU tensor
    included."""
    bf16 = torch.bfloat16
    _check_cuda(what, q=(q, bf16), k=(k, bf16), v=(v, bf16))
    _on_cpu(q, k, v)  # one device
    b, h, l, d = _check(what, q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0 or h == 0 or l == 0:
        return out
    lib = _build.library("attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn_name)(_ptr(q), _ptr(k), _ptr(v), _ptr(out),
                                    b, h, l, d, stream)
    _build.check(lib, err, what)
    _count(wrapper)
    return out


def causal_mha_small_head(q, k, v):
    """Causal MHA, q/k/v ``[B, H, L, D]`` bf16 → bf16 (K4): the CUDA kernel
    ``pio_causal_mha_small_head`` on CUDA tensors, its plain version on CPU
    tensors (the contract of :func:`_check` holds on both)."""
    what = "causal_mha_small_head"
    if _on_cpu(q, k, v):
        _check(what, q, k, v)
        return causal_mha_small_head_reference(q, k, v)
    return _launch(what, "pio_causal_mha_small_head", causal_mha_small_head,
                   q, k, v)


causal_mha_small_head.launches = 0


def flash_causal_attention(q, k, v, block: int):
    """Causal flash attention, q/k/v ``[B, H, L, D]`` bf16 → bf16 (K5).
    ``block`` is the reference's flash block (``flash_block_size(L)``) and
    must divide L. The CUDA kernel ``pio_flash_causal`` on CUDA tensors,
    its plain version on CPU tensors (the contract of :func:`_check` holds
    on both)."""
    what = "flash_causal_attention"
    l = _check(what, q, k, v)[2]
    if block <= 0 or block % TILE or l % block:
        raise ValueError(f"{what}: block {block} must be a multiple of "
                         f"{TILE} that divides L {l}")
    if _on_cpu(q, k, v):
        return flash_causal_attention_reference(q, k, v, block)
    return _launch(what, "pio_flash_causal", flash_causal_attention, q, k, v)


flash_causal_attention.launches = 0

#: the wrappers whose ``launches`` count kernel launches
KERNEL_WRAPPERS = (causal_mha_small_head, flash_causal_attention)


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for w in KERNEL_WRAPPERS:
            w.launches = 0
