"""Ring attention over the ``seq`` mesh axis, single-device causal
attention and its routing to the attention kernels.

Counterpart of ``incubator_predictionio_tpu/parallel/ring.py``: ring
attention (:func:`_chunk_attend`, :func:`ring_attention`,
:func:`ring_attention_sharded`, reference :47-140) and the single-device
part that serving and training run (:func:`flash_block_size`,
:func:`causal_attention`, :func:`causal_attention_reference`). Both kernel
routes carry gradients (the kernels are autograd Functions, and the
transposes and casts around them are autograd ops).

The ring is sequence parallelism: each process of a ``seq`` line holds one
chunk of the positions; its Q chunk stays while the K/V chunks rotate
around the line (:func:`~incubator_predictionio_tpu_torch.parallel.mesh.ppermute`,
the reference's ``jax.lax.ppermute``; its backward is the reverse shift),
and the softmax accumulates online, flash-style, in fp32. It is plain
PyTorch, as the reference's is plain XLA (no Pallas kernel).

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
from incubator_predictionio_tpu_torch.parallel.mesh import ppermute


def _bf16_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 and back to fp32: a product of two such
    values is exact in fp32, so an fp32 matmul of them is the reference's
    bf16 matmul with fp32 accumulation (its gradient rounds to bf16 on the
    way back, as the reference's cast does)."""
    return x.to(torch.bfloat16).float()


def _chunk_attend(q, k, v, mask, m, l, o):
    """ring.py:47: one online-softmax update with an extra additive mask.

    q: ``[B, Lq, H, D]``; k/v: ``[B, Lk, H, D]``; mask: ``[Lq, Lk]``
    additive (0/-inf); m/l: ``[B, H, Lq]`` running max / denominator; o:
    ``[B, Lq, H, D]`` numerator. q·kᵀ and p·v over bf16 operands summed in
    fp32; a row whose running max is still -inf (wholly masked so far)
    takes alpha 0, not NaN (the reference's ``isfinite`` guard)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = (_bf16_operand(x).transpose(1, 2) for x in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # [B, H, Lq, Lk]
    s = s + mask
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(torch.where(torch.isfinite(m), m - m_new, -torch.inf))
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(-1)
    pv = torch.matmul(_bf16_operand(p), vf)  # [B, H, Lq, D]
    o_new = o * alpha.transpose(1, 2)[..., None] + pv.transpose(1, 2)
    return m_new, l_new, o_new


def ring_attention(q, k, v, mesh, axis_name: str = "seq"):
    """ring.py:84: causal ring attention for this process's chunk.

    q, k, v: ``[B, Lc, H, D]`` — this process's chunk of the length ``L =
    Lc × s`` sequence, ``s`` the size of its ``axis_name`` line in
    ``mesh`` (a :class:`~incubator_predictionio_tpu_torch.parallel.mesh.DeviceContext`).
    Returns ``[B, Lc, H, D]`` in q's dtype. Causality is by chunk index:
    the process at ring position ``i`` attends chunks ``j < i`` fully, its
    own chunk causally, and chunks ``j > i`` through an all ``-inf`` mask
    (alpha 1 and p 0: o and l unchanged), as the reference does; every
    process attends every chunk, so each rotation's output reaches the
    loss on every process and the backward's reverse shifts meet. K and V
    rotate stacked, one exchange a step, in the dtype they arrive in (the
    projections' fp32, as the reference's). The one shortcut taken: the
    scan's last rotation, whose result the reference discards, is not
    made (``s − 1`` exchanges forward, ``s − 1`` backward)."""
    s_size = mesh.axis_size_or(axis_name)
    my = mesh.axis_index(axis_name)
    b, lc, h, d = q.shape
    dev = q.device
    zeros = torch.zeros((lc, lc), device=dev)
    causal = zeros.masked_fill(
        torch.ones((lc, lc), dtype=torch.bool, device=dev).triu(1), -torch.inf)
    neg = torch.full((lc, lc), -torch.inf, device=dev)
    m = torch.full((b, h, lc), -torch.inf, device=dev)
    l = torch.zeros((b, h, lc), device=dev)
    o = torch.zeros((b, lc, h, d), device=dev)
    kv = torch.stack([k, v])
    for step in range(s_size):
        j = (my - step) % s_size  # origin chunk of the K/V held now
        mask = causal if j == my else (zeros if j < my else neg)
        m, l, o = _chunk_attend(q, kv[0], kv[1], mask, m, l, o)
        if step < s_size - 1:
            kv = ppermute(mesh, kv, axis_name, 1)
    out = o / torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, data_axis: str = "data",
                           seq_axis: str = "seq"):
    """ring.py:126: q/k/v are this process's ``[B_local, L / s, H, D]``
    block of the global ``[B, L, H, D]`` (B over ``data_axis``, L over
    ``seq_axis``). The batch needs no exchange: each process's rows attend
    among themselves, so this is :func:`ring_attention` over ``seq_axis``.
    A mesh without ``seq_axis`` raises ``ValueError`` naming it, as the
    reference's sharding does."""
    if seq_axis not in mesh.axis_names:
        raise ValueError(
            f"ring attention: the mesh has no {seq_axis!r} axis (mesh axes "
            f"{list(mesh.axis_names)}); the sequence shards over it")
    return ring_attention(q, k, v, mesh, seq_axis)


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
