"""Causal multi-head attention of the sequential recommender — hand-written
CUDA kernels, forward and backward.

Counterpart of ``incubator_predictionio_tpu/ops/attention.py`` (K4, the
small-head kernel, and its backward ``_mha_bwd``) and of the library flash
kernel that ``incubator_predictionio_tpu/parallel/ring.py:causal_attention``
calls for long sequences (K5, and its backward ``_flash_attention_bwd``).
Both take the reference kernels' layout: q, k, v ``[B, H, L, D]`` bf16 in,
``[B, H, L, D]`` bf16 out, scale ``1/sqrt(D)``.

- :func:`causal_mha_small_head` (K4) normalises ``p = exp(s - m) / l`` in
  fp32 before rounding it to bf16 for the PV product, as the TPU kernel does
  with its whole ``[L, L]`` block. Its CUDA counterpart gets there in two
  passes over the key tiles (statistics, then output). Under autograd its
  forward keeps q, k, v (as ``_mha_fwd`` does) and the first pass's row
  max ``m`` and sum ``l``; its backward :func:`causal_mha_small_head_bwd`
  recomputes the scores, ``p`` and the row term ``rowsum(dp · p)`` in
  fp32.
- :func:`flash_causal_attention` (K5) is one pass of online softmax: a
  running max and sum, an fp32 accumulator rescaled as the max moves, ``p``
  rounded to bf16 before PV and one division by the row sum at the end.
  Under autograd its forward also keeps each row's max ``m`` and sum ``l``
  (the library's residuals); the backward forms ``p = exp(s - m) · (1/l)``
  and ``di = rowsum(o · do)`` and runs :func:`flash_causal_attention_bwd_dkv`
  and :func:`flash_causal_attention_bwd_dq`.

K4's kernels live in ``csrc/attention.cu``, K5's in
``csrc/flash_attention.cu``, both on the Hopper building blocks (wgmma,
cp.async into swizzled tiles) and backward bodies of the shared header
``csrc/attention_sm90.cuh``; :mod:`._build` builds them, and the notes
there say what bounds them on an H100. Beside each sits its plain
PyTorch version (``*_reference``). The wrappers take the plain version only
for tensors on the CPU; given CUDA tensors they launch the kernel or raise.
Each kernel wrapper counts its launches in ``launches``
(:data:`KERNEL_WRAPPERS`).
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

#: key columns per tile of the CUDA kernels (K4's query tiles too); L must
#: be a multiple of it
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


def _small_head_reference(q, k, v):
    """K4's plain forward with its statistics: (out, m, l), m and l fp32
    ``[B, H, L]`` — each row's max score and ``Σ exp(s - m)``."""
    s = _scores(q, k)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    p = p / l[..., None]
    o = torch.matmul(p.to(torch.bfloat16).float(), v.float())
    return o.to(q.dtype), m, l


def causal_mha_small_head_reference(q, k, v):
    """The plain PyTorch version of K4, in the TPU kernel's order (its
    ``_fwd_kernel``): fp32 scores, ``p = exp(s - max) / sum`` in fp32,
    ``p`` rounded to bf16, ``p·v`` summed in fp32, the output in bf16."""
    return _small_head_reference(q, k, v)[0]


def _flash_reference(q, k, v, block: int):
    """K5's plain forward with its statistics: (out, m, l), m and l fp32
    ``[B, H, L]`` — each row's final running max and sum."""
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
    return (acc / den[..., None]).to(q.dtype), m, den


def flash_causal_attention_reference(q, k, v, block: int):
    """The plain PyTorch version of K5: online softmax over key blocks of
    ``block`` columns, as the library flash kernel walks them — a running
    max ``m`` and sum ``l`` in fp32, the accumulator rescaled by
    ``exp(m_old - m_new)``, ``p`` rounded to bf16 before PV, and one
    division by ``l`` at the end. (The CUDA kernel walks the same keys in
    :data:`TILE`-wide tiles; in exact arithmetic the two agree, and in fp32
    they differ by the bf16 rounding of ``p`` against another running max.)
    """
    return _flash_reference(q, k, v, block)[0]


def causal_mha_small_head_bwd_reference(q, k, v, do):
    """The plain backward of K4, line by line the TPU kernel's
    ``_bwd_kernel`` (ops/attention.py:75-107), all heads at once: ``p``
    normalised in fp32, ``dv = p_bf16ᵀ·do``, ``dp = do·vᵀ``, ``ds = p ·
    (dp - rowsum(dp·p))`` with the row term from fp32 ``p`` and ``dp``,
    ``ds·scale`` rounded to bf16, ``dq = ds·k``, ``dk = dsᵀ·q``; products
    of bf16 values summed in fp32, every output in bf16."""
    bf = torch.bfloat16
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = (x.to(bf).float() for x in (q, k, v, do))
    s = _scores(q, k)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(bf).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds_bf = (ds * scale).to(bf).float()
    dq = torch.matmul(ds_bf, kf)
    dk = torch.matmul(ds_bf.transpose(-1, -2), qf)
    return dq.to(bf), dk.to(bf), dv.to(bf)


def _flash_bwd_terms(q, k, v, do, m, l, di):
    """K5's backward terms from its residuals, as the library's two
    kernels form them (flash_attention.py:894-914): ``p = exp(s - m) ·
    (1/l)``, ``ds = (dp - di) · p · scale``, both rounded to bf16; with
    q, k and do as fp32 tensors of bf16 values."""
    bf = torch.bfloat16
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = (x.to(bf).float() for x in (q, k, v, do))
    p = torch.exp(_scores(q, k) - m[..., None]) * (1.0 / l)[..., None]
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds_bf = ((dp - di[..., None]) * p * scale).to(bf).float()
    return qf, kf, dof, p.to(bf).float(), ds_bf


def _dkv_from_terms(terms, block: int):
    """``dv = Σ p_bf16ᵀ·do`` and ``dk = Σ ds_bf16ᵀ·q`` summed over query
    blocks, each block product in fp32; bf16 out."""
    qf, _, dof, p_bf, ds_bf = terms
    dk, dv = torch.zeros_like(qf), torch.zeros_like(qf)
    for b0 in range(0, qf.shape[-2], block):
        blk = slice(b0, b0 + block)
        dv = dv + torch.matmul(p_bf[..., blk, :].transpose(-1, -2), dof[..., blk, :])
        dk = dk + torch.matmul(ds_bf[..., blk, :].transpose(-1, -2), qf[..., blk, :])
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def _dq_from_terms(terms, block: int):
    """``dq = Σ ds_bf16·k`` over key blocks, each block product in fp32;
    bf16 out."""
    _, kf, _, _, ds_bf = terms
    dq = torch.zeros_like(kf)
    for b0 in range(0, kf.shape[-2], block):
        blk = slice(b0, b0 + block)
        dq = dq + torch.matmul(ds_bf[..., :, blk], kf[..., blk, :])
    return dq.to(torch.bfloat16)


def flash_causal_attention_bwd_dkv_reference(q, k, v, do, m, l, di, block: int):
    """K5's plain dk/dv (bf16) from its residuals and ``di``."""
    return _dkv_from_terms(_flash_bwd_terms(q, k, v, do, m, l, di), block)


def flash_causal_attention_bwd_dq_reference(q, k, v, do, m, l, di, block: int):
    """K5's plain dq (bf16) from its residuals and ``di``."""
    return _dq_from_terms(_flash_bwd_terms(q, k, v, do, m, l, di), block)


def _row_term(o, do):
    """``di = rowsum(o · do)`` in fp32 from the bf16 output, as the library
    computes it outside its kernels (flash_attention.py:273)."""
    return (o.float() * do.float()).sum(dim=-1)


def flash_causal_attention_bwd_reference(q, k, v, o, do, m, l, block: int):
    """The plain backward of K5: (dq, dk, dv) bf16 from q, k, v, the
    forward's output ``o`` and statistics ``m``, ``l``, and ``do``."""
    do = do.to(torch.bfloat16)
    terms = _flash_bwd_terms(q, k, v, do, m, l, _row_term(o, do))
    return (_dq_from_terms(terms, block), *_dkv_from_terms(terms, block))


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


def _check_block(what: str, l: int, block: int) -> None:
    if block <= 0 or block % TILE or l % block:
        raise ValueError(f"{what}: block {block} must be a multiple of "
                         f"{TILE} that divides L {l}")


def _check_rows(what: str, q, **stats) -> None:
    """The per-row statistics' contract: fp32 ``[B, H, L]``, contiguous."""
    for name, t in stats.items():
        if tuple(t.shape) != tuple(q.shape[:-1]):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != "
                             f"[B, H, L] {tuple(q.shape[:-1])}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _bf16_grad(what: str, q, do):
    """``do`` cast to bf16 and made contiguous (ops/attention.py:148), of
    q's shape."""
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"{what}: do shape {tuple(do.shape)} != "
                         f"q shape {tuple(q.shape)}")
    return do.to(torch.bfloat16).contiguous()


def _call(what: str, lib_name: str, fn_name: str, wrapper, tensors,
          shape) -> None:
    """Launch ``fn_name`` of the library ``lib_name`` (``csrc/<lib_name>.cu``:
    "attention" for K4, "flash_attention" for K5) on the current stream of
    the tensors' card, with the pointers of ``tensors`` (None: a null
    pointer) and ``shape`` (B, H, L, D), and count the launch on
    ``wrapper``. Raises on a CPU tensor, on a tensor of another card and on
    a misaligned one."""
    _check_cuda(what, **{f"#{i}": (t, t.dtype if t is not None else None)
                         for i, t in enumerate(tensors)})
    _on_cpu(*tensors)  # one device
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be 16-byte aligned")
    lib = _build.library(lib_name)
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(*(_ptr(t) for t in tensors), *shape, stream)
    _build.check(lib, err, what)
    _count(wrapper)


def _rows(q):
    """An fp32 ``[B, H, L]`` tensor for per-row statistics."""
    return torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)


def _launch(what: str, lib_name: str, fn_name: str, wrapper, q, k, v,
            stats: bool = False):
    """Launch one of the attention forward kernels on q's current stream
    and count the launch: out, or with ``stats`` (out, m, l) — each row's
    max and sum, written beside an ``out`` that stays bitwise the same.
    Raises on anything the kernel does not take, a CPU tensor included."""
    shape = _check(what, q, k, v)
    out = torch.empty_like(q)
    m, l = (_rows(q), _rows(q)) if stats else (None, None)
    if q.numel():
        _call(what, lib_name, fn_name, wrapper, (q, k, v, out, m, l), shape)
    return (out, m, l) if stats else out


def _forward(kernel: str, q, k, v, block: int, stats: bool):
    """K4 (``kernel`` "small_head") or K5 ("flash") forward: out, or with
    ``stats`` (out, m, l). The CUDA kernel on CUDA tensors, its plain
    version on CPU tensors."""
    if _on_cpu(q, k, v):
        res = (_small_head_reference(q, k, v) if kernel == "small_head"
               else _flash_reference(q, k, v, block))
        return res if stats else res[0]
    if kernel == "small_head":
        wrapper, lib_name, fn_name = (causal_mha_small_head, "attention",
                                      "pio_causal_mha_small_head")
    else:
        wrapper, lib_name, fn_name = (flash_causal_attention, "flash_attention",
                                      "pio_flash_causal")
    return _launch(wrapper.__name__, lib_name, fn_name, wrapper, q, k, v, stats)


class _Attention(torch.autograd.Function):
    """K4 or K5 under autograd. When a gradient is wanted the forward also
    writes each row's max ``m`` and sum ``l`` and keeps (q, k, v, o, m,
    l), as the library's ``_flash_attention_fwd`` does
    (flash_attention.py:251); the backward is
    :func:`causal_mha_small_head_bwd` or :func:`flash_causal_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, kernel, block):
        ctx.kernel, ctx.block = kernel, block
        if not any(ctx.needs_input_grad[:3]):
            return _forward(kernel, q, k, v, block, stats=False)
        o, m, l = _forward(kernel, q, k, v, block, stats=True)
        ctx.save_for_backward(q, k, v, o, m, l)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        if ctx.kernel == "small_head":
            grads = causal_mha_small_head_bwd(q, k, v, do, m, l)
        else:
            grads = flash_causal_attention_bwd(q, k, v, o, do, m, l, ctx.block)
        return (*grads, None, None)


def causal_mha_small_head(q, k, v):
    """Causal MHA, q/k/v ``[B, H, L, D]`` bf16 → bf16 (K4): the CUDA kernel
    ``pio_causal_mha_small_head`` on CUDA tensors, its plain version on CPU
    tensors (the contract of :func:`_check` holds on both). Differentiable:
    the gradient runs :func:`causal_mha_small_head_bwd`."""
    _check("causal_mha_small_head", q, k, v)
    return _Attention.apply(q, k, v, "small_head", 0)


causal_mha_small_head.launches = 0


def causal_mha_small_head_with_stats(q, k, v):
    """K4's forward with its residuals: (out bf16, m, l fp32 ``[B, H,
    L]``), ``out`` bitwise :func:`causal_mha_small_head`'s (the launch
    counts on that wrapper)."""
    _check("causal_mha_small_head", q, k, v)
    return _forward("small_head", q, k, v, 0, stats=True)


def causal_mha_small_head_bwd(q, k, v, do, m, l):
    """K4's backward: (dq, dk, dv) bf16 ``[B, H, L, D]`` from q, k, v, the
    output gradient ``do`` (cast to bf16, made contiguous) and the
    forward's row statistics ``m``, ``l``. On CUDA tensors the kernel
    ``pio_causal_mha_small_head_bwd`` — two launches, dq (which computes
    each row's term ``rowsum(dp · p)`` into fp32 scratch) then dk/dv —
    counted once; on CPU tensors its plain version, which recomputes m and
    l as the TPU kernel does."""
    what = "causal_mha_small_head_bwd"
    shape = _check(what, q, k, v)
    do = _bf16_grad(what, q, do)
    _check_rows(what, q, m=m, l=l)
    if _on_cpu(q, k, v, do, m, l):
        return causal_mha_small_head_bwd_reference(q, k, v, do)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel():
        _call(what, "attention", "pio_causal_mha_small_head_bwd",
              causal_mha_small_head_bwd,
              (q, k, v, do, m, l, _rows(q), dq, dk, dv), shape)
    return dq, dk, dv


causal_mha_small_head_bwd.launches = 0


def flash_causal_attention(q, k, v, block: int):
    """Causal flash attention, q/k/v ``[B, H, L, D]`` bf16 → bf16 (K5).
    ``block`` is the reference's flash block (``flash_block_size(L)``) and
    must divide L. The CUDA kernel ``pio_flash_causal`` on CUDA tensors,
    its plain version on CPU tensors (the contract of :func:`_check` holds
    on both). Differentiable: the gradient runs
    :func:`flash_causal_attention_bwd`."""
    what = "flash_causal_attention"
    l = _check(what, q, k, v)[2]
    _check_block(what, l, block)
    return _Attention.apply(q, k, v, "flash", block)


flash_causal_attention.launches = 0


def flash_causal_attention_with_stats(q, k, v, block: int):
    """K5's forward with its residuals: (out bf16, m, l fp32 ``[B, H,
    L]``), ``out`` bitwise :func:`flash_causal_attention`'s (the launch
    counts on that wrapper)."""
    what = "flash_causal_attention"
    _check_block(what, _check(what, q, k, v)[2], block)
    return _forward("flash", q, k, v, block, stats=True)


def _flash_bwd_args(what, q, k, v, do, m, l, di, block):
    """The K5 backward kernels' contract; returns (B, H, L, D) and ``do``
    as the kernels take it."""
    shape = _check(what, q, k, v)
    _check_block(what, shape[2], block)
    do = _bf16_grad(what, q, do)
    _check_rows(what, q, m=m, l=l, di=di)
    return shape, do


def flash_causal_attention_bwd_dkv(q, k, v, do, m, l, di, block: int):
    """K5's backward, dk and dv (bf16): the kernel ``pio_flash_causal_bwd_dkv``
    on CUDA tensors (one block per 64-key tile, walking the query rows at
    or below the diagonal), the plain version on CPU tensors. ``m``, ``l``
    are the forward's statistics, ``di = rowsum(o · do)``."""
    what = "flash_causal_attention_bwd_dkv"
    shape, do = _flash_bwd_args(what, q, k, v, do, m, l, di, block)
    if _on_cpu(q, k, v, do, m, l, di):
        return flash_causal_attention_bwd_dkv_reference(q, k, v, do, m, l, di, block)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    if q.numel():
        _call(what, "flash_attention", "pio_flash_causal_bwd_dkv",
              flash_causal_attention_bwd_dkv,
              (q, k, v, do, m, l, di, dk, dv), shape)
    return dk, dv


flash_causal_attention_bwd_dkv.launches = 0


def flash_causal_attention_bwd_dq(q, k, v, do, m, l, di, block: int):
    """K5's backward, dq (bf16): the kernel ``pio_flash_causal_bwd_dq`` on
    CUDA tensors (one block per query tile, walking the key tiles up to
    the diagonal), the plain version on CPU tensors."""
    what = "flash_causal_attention_bwd_dq"
    shape, do = _flash_bwd_args(what, q, k, v, do, m, l, di, block)
    if _on_cpu(q, k, v, do, m, l, di):
        return flash_causal_attention_bwd_dq_reference(q, k, v, do, m, l, di, block)
    dq = torch.empty_like(q)
    if q.numel():
        _call(what, "flash_attention", "pio_flash_causal_bwd_dq",
              flash_causal_attention_bwd_dq,
              (q, k, v, do, m, l, di, dq), shape)
    return dq


flash_causal_attention_bwd_dq.launches = 0


def flash_causal_attention_bwd(q, k, v, o, do, m, l, block: int):
    """K5's backward (``_flash_attention_bwd``, flash_attention.py:254):
    ``di = rowsum(o · do)`` from the bf16 ``o`` (a torch reduction, as the
    library's is outside its kernels), then the dk/dv and dq kernels.
    Returns (dq, dk, dv) bf16."""
    do = _bf16_grad("flash_causal_attention_bwd", q, do)
    di = _row_term(o, do)
    dk, dv = flash_causal_attention_bwd_dkv(q, k, v, do, m, l, di, block)
    dq = flash_causal_attention_bwd_dq(q, k, v, do, m, l, di, block)
    return dq, dk, dv


#: the wrappers whose ``launches`` count kernel launches: K4 and K5 forward
#: (with or without statistics), K4 backward, K5 backward dk/dv and dq
KERNEL_WRAPPERS = (causal_mha_small_head, flash_causal_attention,
                   causal_mha_small_head_bwd, flash_causal_attention_bwd_dkv,
                   flash_causal_attention_bwd_dq)


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for w in KERNEL_WRAPPERS:
            w.launches = 0
