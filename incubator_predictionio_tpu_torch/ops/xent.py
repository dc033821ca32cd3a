"""Weighted next-item cross-entropy over the tied item embedding.

Counterpart of ``incubator_predictionio_tpu/ops/xent.py``: the sequential
recommender's loss ``Σ_t weights[t] · xent(h[t] @ w_embᵀ, targets[t])``.

- :func:`weighted_xent_sum` takes the reference's small path while the
  logits matrix has at most :data:`CHUNKED_THRESHOLD` elements: bf16
  logits from a bf16 matmul summed in fp32, an fp32 logsumexp, the gradient
  from autograd (xent.py:51-57).
- Beyond it, :func:`chunked_xent_sum`, a :class:`torch.autograd.Function`
  whose forward and backward mirror ``_xent_fwd`` and ``_xent_bwd``
  (xent.py:103-156): per chunk of tokens, fp32 logits of bf16 operands,
  reduced at once and discarded; the backward recomputes each chunk's
  logits and folds them into ``dh``, ``dW`` and ``dweights``.

The reference runs these matmuls outside any Pallas kernel (XLA's), so the
port leaves them to ``torch.matmul``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: above this many logits elements (tokens × vocab) the loss takes the
#: chunked path (the reference's threshold, xent.py:42)
CHUNKED_THRESHOLD = 1 << 29


def weighted_xent_sum(h, w_emb, targets, weights):
    """``Σ_t weights[t] · xent(h[t] @ w_embᵀ, targets[t])``: h ``[S, d]``
    fp32, w_emb ``[V, d]``, targets ``[S]`` int, weights ``[S]`` fp32 →
    fp32 scalar. Small problems take one bf16-logits pass with an fp32
    logsumexp; large ones :func:`chunked_xent_sum`."""
    if h.shape[0] * w_emb.shape[0] <= CHUNKED_THRESHOLD:
        bf = torch.bfloat16
        logits = torch.matmul(h.to(bf), w_emb.to(bf).T)  # bf16, fp32 sums
        lse = torch.logsumexp(logits.float(), dim=-1)
        correct = logits.gather(1, targets[:, None].long())[:, 0].float()
        return torch.sum(weights * (lse - correct))
    return chunked_xent_sum(h, w_emb, targets, weights)


def _f32_matmul(a, b):
    """``a @ b`` over bf16 operands, summed and returned in fp32 (the
    reference's ``preferred_element_type=float32``): on a card the tensor
    cores' bf16 product with an fp32 output, on the CPU the same function
    as an fp32 matmul of the bf16 values (their products are exact)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _pad_chunks(h, targets, weights, chunk: int):
    """xent.py:61 ``_pad_chunks``: pad the token dim to whole chunks of
    ``min(S, chunk)`` rows; pad rows carry weight 0 and target 0."""
    s, d = h.shape
    c = min(s, chunk)
    pad = (-s) % c
    if pad:
        h = torch.cat([h, h.new_zeros(pad, d)])
        targets = torch.cat([targets, targets.new_zeros(pad)])
        weights = torch.cat([weights, weights.new_zeros(pad)])
    return h.reshape(-1, c, d), targets.reshape(-1, c), weights.reshape(-1, c)


class _ChunkedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w_emb, targets, weights, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(h, w_emb, targets, weights)
        hc, tc, wc = _pad_chunks(h, targets, weights, chunk)
        w_t = w_emb.to(torch.bfloat16).T
        loss = torch.zeros((), dtype=torch.float32, device=h.device)
        for h_c, t_c, w_c in zip(hc, tc, wc):
            logits = _f32_matmul(h_c.to(torch.bfloat16), w_t)  # [C, V] fp32
            lse = torch.logsumexp(logits, dim=-1)
            correct = logits.gather(1, t_c[:, None].long())[:, 0]
            loss = loss + torch.sum(w_c * (lse - correct))
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w_emb, targets, weights = ctx.saved_tensors
        s, d = h.shape
        hc, tc, wc = _pad_chunks(h, targets, weights, ctx.chunk)
        bf = torch.bfloat16
        w_bf = w_emb.to(bf)
        v = w_emb.shape[0]
        dw = torch.zeros(w_emb.shape, dtype=torch.float32, device=h.device)
        dh, dweights = [], []
        for h_c, t_c, w_c in zip(hc, tc, wc):
            t_c = t_c.long()
            logits = _f32_matmul(h_c.to(bf), w_bf.T)  # recompute [C, V]
            m = logits.amax(dim=-1, keepdim=True)
            e = torch.exp(logits - m)
            z = e.sum(dim=-1, keepdim=True)
            p = e / z
            lse = torch.log(z[:, 0]) + m[:, 0]
            correct = logits.gather(1, t_c[:, None])[:, 0]
            sc = w_c * g
            # dlogits = (p − onehot(t))·sc, split as the reference does:
            #   dh = p·sc @ W − W[t]·sc,  dW = (p·sc)ᵀ @ h − onehotᵀ·sc @ h
            p_sc = (p * sc[:, None]).to(bf)
            h_bf = h_c.to(bf)
            dh.append(_f32_matmul(p_sc, w_bf) - w_emb[t_c] * sc[:, None])
            onehot = F.one_hot(t_c, v).to(bf) * sc[:, None].to(bf)
            dw += _f32_matmul(p_sc.T, h_bf) - _f32_matmul(onehot.T, h_bf)
            dweights.append((lse - correct) * g)  # per-token CE
        return (torch.cat(dh)[:s].to(h.dtype), dw.to(w_emb.dtype), None,
                torch.cat(dweights)[:s].to(weights.dtype), None)


def chunked_xent_sum(h, w_emb, targets, weights, chunk: int = 4096):
    """``Σ_t weights[t] · xent(h[t] @ w_embᵀ, targets[t])`` without the
    full logits matrix: h ``[S, d]``, w_emb ``[V, d]``, targets ``[S]``
    int, weights ``[S]`` fp32 → fp32 scalar (callers divide by Σweights).
    Differentiable in h, w_emb and weights."""
    return _ChunkedXent.apply(h, w_emb, targets, weights, chunk)
