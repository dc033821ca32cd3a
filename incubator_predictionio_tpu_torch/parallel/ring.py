"""Single-device causal attention and its routing to the attention kernels.

Counterpart of ``incubator_predictionio_tpu/parallel/ring.py``, cut to the
single-device part that serving and training run: :func:`flash_block_size`,
:func:`causal_attention` and :func:`causal_attention_reference`. Both
kernel routes carry gradients (the kernels are autograd Functions, and the
transposes and casts around them are autograd ops). Ring attention
(sequence parallelism over a ``seq`` mesh axis) comes with the sharding
slice (ROADMAP.md).

Layout here is the reference's ``[B, L, H, D]``; the kernels in
:mod:`incubator_predictionio_tpu_torch.ops.attention` take ``[B, H, L, D]``.
"""

from __future__ import annotations

import math

import torch

from incubator_predictionio_tpu_torch.ops.attention import (
    causal_mha_small_head,
    fits_small_head_kernel,
    flash_causal_attention,
)


def flash_block_size(l: int):
    """Copy of ``incubator_predictionio_tpu/parallel/ring.py:flash_block_size``
    (:142): the reference's flash block at sequence length ``l``, or
    ``None`` when the materializing reference is its path (short or
    tile-unaligned sequences). The largest of 512/256/128 that divides L."""
    if l < 256 or l % 128 != 0:
        return None
    return 512 if l % 512 == 0 else (256 if l % 256 == 0 else 128)


def attention_route(b: int, l: int, h: int, d: int) -> str:
    """Where :func:`causal_attention` sends a CUDA tensor of shape
    ``[b, l, h, d]``: ``"small_head"`` (kernel K4), ``"flash"`` (kernel K5)
    or ``"reference"`` — the reference's decision on a TPU (ring.py:167-210)."""
    if fits_small_head_kernel(b, l, h, d):
        return "small_head"
    if flash_block_size(l) is not None:
        return "flash"
    return "reference"


def causal_attention(q, k, v):
    """Causal attention, q/k/v ``[B, L, H, D]`` → ``[B, L, H, D]`` in q's
    dtype (bf16-valued: the kernels write bf16).

    On CUDA tensors it routes where the reference routes on a TPU: the
    small-head kernel (K4) where ``fits_small_head_kernel`` holds, else the
    flash kernel (K5) when ``flash_block_size(L)`` gives a block, else
    :func:`causal_attention_reference` (the reference runs that outside
    any Pallas kernel too). On CPU tensors it is
    :func:`causal_attention_reference`, as the reference is on any platform
    but a TPU."""
    b, l, h, d = q.shape
    route = "reference" if q.device.type == "cpu" else attention_route(b, l, h, d)
    if route == "reference":
        return causal_attention_reference(q, k, v)
    qt, kt, vt = (x.transpose(1, 2).to(torch.bfloat16).contiguous()
                  for x in (q, k, v))
    if route == "small_head":
        out = causal_mha_small_head(qt, kt, vt)
    else:
        out = flash_causal_attention(qt, kt, vt, flash_block_size(l))
    return out.transpose(1, 2).to(q.dtype)


def causal_attention_reference(q, k, v):
    """Plain causal attention (ring.py:213): q·kᵀ over bf16 operands summed
    in fp32, fp32 softmax, p·v over bf16 operands summed in fp32, the output
    in q's dtype. Products of bf16 values are exact in fp32, so the matmuls
    run in fp32 over the bf16-rounded operands."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    bf = torch.bfloat16
    qf, kf, vf = (x.to(bf).float().transpose(1, 2) for x in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # [B, H, L, L]
    l = q.shape[1]
    upper = torch.ones(l, l, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(upper, -torch.inf), dim=-1)
    o = torch.matmul(p.to(bf).float(), vf)  # [B, H, L, D]
    return o.transpose(1, 2).to(q.dtype)
