"""PyTorch port, the backwards of kernels K4 (small-head causal MHA) and K5
(causal flash attention): their plain versions held against ``jax.grad`` of
the JAX package on the same numpy inputs, the ``torch.autograd.Function``s
on CPU tensors against those plain versions, and the backward wrappers'
contract.

Tolerance: 2e-2 of each gradient's max abs, the reference's own
(tests/test_small_head_attention.py:55-58). The gradients are bf16 and
their products are rounded to bf16 at other places in the two packages
(``p`` and ``ds`` before their matmuls, against another summation order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.ops import attention as jatt  # noqa: E402
from incubator_predictionio_tpu.parallel import ring as jring  # noqa: E402
from incubator_predictionio_tpu_torch.ops import attention as tatt  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import ring as tring  # noqa: E402

TOL = 2e-2


def _inputs(shape, seed):
    """q, k, v, do as bf16-valued fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return tuple(np.array(jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
                          .astype(jnp.float32)) for _ in range(4))


def _bf16(*arrays):
    return tuple(torch.from_numpy(a).to(torch.bfloat16).contiguous()
                 for a in arrays)


def _assert_grads_close(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=TOL * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("b,l,h,d", [(2, 128, 4, 64), (1, 256, 2, 64)])
def test_small_head_bwd_plain_matches_jax_kernel_interpret(b, l, h, d):
    """K4's plain backward against ``jax.grad`` of the JAX package's
    ``causal_mha_small_head`` in interpret mode (its Pallas backward),
    at the shapes of tests/test_small_head_attention.py:43."""
    q, k, v, do = _inputs((b, h, l, d), seed=l + h)
    _, vjp = jax.vjp(lambda *x: jatt.causal_mha_small_head(*x, True),
                     *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    got = tatt.causal_mha_small_head_bwd_reference(*_bf16(q, k, v, do))
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_grads_close(got, [np.asarray(w.astype(jnp.float32)) for w in want])


@pytest.mark.parametrize("l,block", [(256, 128), (256, 256), (512, 128),
                                     (512, 256)])
def test_flash_bwd_plain_matches_jax_reference_grad(l, block):
    """K5's plain backward (from its own forward's o, m, l) against
    ``jax.grad`` of the JAX ``causal_attention_reference``; the library
    flash kernel runs on a TPU only."""
    b, h, d = 2, 2, 64
    q, k, v, do = _inputs((b, l, h, d), seed=l + block)
    _, vjp = jax.vjp(jring.causal_attention_reference,
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(w).transpose(0, 2, 1, 3) for w in vjp(jnp.asarray(do))]
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                       for x in _bf16(q, k, v, do))
    o, m, l_sum = tatt.flash_causal_attention_with_stats(qt, kt, vt, block)
    assert m.dtype == l_sum.dtype == torch.float32 and m.shape == (b, h, l)
    got = tatt.flash_causal_attention_bwd_reference(qt, kt, vt, o, dot, m,
                                                    l_sum, block)
    _assert_grads_close(got, want)


def test_small_head_stats_are_the_rows_max_and_sum():
    """K4's forward with statistics: the same output, m each row's max of
    the scaled causal scores and l the sum of exp(s - m) — what its
    backward would recompute."""
    q, k, v = _bf16(*_inputs((1, 2, 256, 64), seed=4)[:3])
    o, m, l = tatt.causal_mha_small_head_with_stats(q, k, v)
    torch.testing.assert_close(o, tatt.causal_mha_small_head_reference(q, k, v),
                               rtol=0, atol=0)
    s = tatt._scores(q, k)
    assert m.dtype == l.dtype == torch.float32 and m.shape == (1, 2, 256)
    torch.testing.assert_close(m, s.amax(-1), rtol=0, atol=0)
    torch.testing.assert_close(l, torch.exp(s - m[..., None]).sum(-1),
                               rtol=1e-6, atol=0)


def test_flash_stats_are_the_rows_max_and_sum():
    """m is each row's max of the scaled causal scores and l the sum of
    exp(s - m): the residuals of the library's forward."""
    q, k, v = _bf16(*_inputs((1, 2, 256, 64), seed=3)[:3])
    o, m, l = tatt.flash_causal_attention_with_stats(q, k, v, 128)
    torch.testing.assert_close(o, tatt.flash_causal_attention_reference(q, k, v, 128),
                               rtol=0, atol=0)
    s = tatt._scores(q, k)
    torch.testing.assert_close(m, s.amax(-1), rtol=0, atol=0)
    torch.testing.assert_close(l, torch.exp(s - m[..., None]).sum(-1),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("kernel", ["small_head", "flash"])
def test_autograd_on_cpu_is_the_plain_backward(kernel):
    """The ``autograd.Function``s on CPU tensors: forward = the plain
    version, gradients = the plain backward, exactly."""
    q, k, v, do = _bf16(*_inputs((2, 2, 256, 64), seed=11))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    if kernel == "small_head":
        out = tatt.causal_mha_small_head(*leaves)
        want_out = tatt.causal_mha_small_head_reference(q, k, v)
        want = tatt.causal_mha_small_head_bwd_reference(q, k, v, do)
    else:
        out = tatt.flash_causal_attention(*leaves, 128)
        want_out, m, l = tatt._flash_reference(q, k, v, 128)
        want = tatt.flash_causal_attention_bwd_reference(q, k, v, want_out,
                                                         do, m, l, 128)
    out.backward(do)
    torch.testing.assert_close(out.detach(), want_out, rtol=0, atol=0)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)


def test_small_head_and_flash_backwards_agree():
    """The two plain backwards compute one gradient in two rounding
    orders."""
    q, k, v, do = _bf16(*_inputs((2, 2, 512, 64), seed=12))
    o, m, l = tatt.flash_causal_attention_with_stats(q, k, v, 256)
    _assert_grads_close(
        tatt.flash_causal_attention_bwd_reference(q, k, v, o, do, m, l, 256),
        [g.float().numpy() for g in
         tatt.causal_mha_small_head_bwd_reference(q, k, v, do)])


@pytest.mark.parametrize("l", [128, 512])
def test_causal_attention_grad_on_cpu_is_the_reference_grad(l):
    """On CPU tensors ``causal_attention`` is the reference, and autograd
    differentiates it: the gradients equal ``jax.grad`` of the JAX
    reference within the kernel tolerance."""
    q, k, v, do = _inputs((2, l, 2, 64), seed=l)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tring.causal_attention(*leaves).backward(torch.from_numpy(do))
    _, vjp = jax.vjp(jring.causal_attention_reference,
                     *(jnp.asarray(x) for x in (q, k, v)))
    _assert_grads_close([x.grad for x in leaves],
                        [np.asarray(w) for w in vjp(jnp.asarray(do))])


def _bwd_bad_inputs():
    q, k, v, do = _bf16(*_inputs((1, 2, 128, 64), seed=1))
    stats = torch.zeros(1, 2, 128)
    return q, k, v, do, stats


@pytest.mark.parametrize("case", ["do_shape", "q_dtype", "head_dim",
                                  "stats_dtype", "stats_shape"])
def test_small_head_bwd_refuses_what_the_kernel_does_not_take(case):
    q, k, v, do, st = _bwd_bad_inputs()
    args = {"do_shape": (q, k, v, do[:, :, :64], st, st),
            "q_dtype": (q.float(), k, v, do, st, st),
            "head_dim": (*_bf16(*_inputs((1, 2, 128, 48), seed=2)), st, st),
            "stats_dtype": (q, k, v, do, st, st.double()),
            "stats_shape": (q, k, v, do, st[:, :1], st)}[case]
    exc = TypeError if case in ("q_dtype", "stats_dtype") else ValueError
    with pytest.raises(exc):
        tatt.causal_mha_small_head_bwd(*args)


@pytest.mark.parametrize("fn", ["bwd_dkv", "bwd_dq"])
@pytest.mark.parametrize("case,exc,match", [
    ("stats_dtype", TypeError, "float32"),
    ("stats_shape", ValueError, r"\[B, H, L\]"),
    ("block", ValueError, "block"),
    ("do_shape", ValueError, "do shape"),
])
def test_flash_bwd_refuses_what_the_kernel_does_not_take(fn, case, exc, match):
    q, k, v, do, st = _bwd_bad_inputs()
    args = {"q": q, "k": k, "v": v, "do": do, "m": st, "l": st, "di": st,
            "block": 128}
    if case == "stats_dtype":
        args["l"] = st.double()
    elif case == "stats_shape":
        args["di"] = st[:, :1]
    elif case == "block":
        args["block"] = 96
    else:
        args["do"] = do[:1, :1]
    wrapper = getattr(tatt, f"flash_causal_attention_{fn}")
    with pytest.raises(exc, match=match):
        wrapper(**args)


@pytest.mark.parametrize("fn,wrapper", [
    ("pio_causal_mha_small_head_bwd", "causal_mha_small_head_bwd"),
    ("pio_flash_causal_bwd_dkv", "flash_causal_attention_bwd_dkv"),
    ("pio_flash_causal_bwd_dq", "flash_causal_attention_bwd_dq"),
    ("pio_causal_mha_small_head", "causal_mha_small_head"),
    ("pio_flash_causal", "flash_causal_attention"),
])
def test_backward_launchers_refuse_cpu_tensors(fn, wrapper):
    """The launch path never takes a CPU tensor (no plain-version fallback
    behind it), and a refused call counts no launch; the plain backwards
    on the CPU count no launch either."""
    q, k, v, do, st = _bwd_bad_inputs()
    lib = "flash_attention" if "flash" in fn else "attention"  # K5's source, K4's
    assert fn in tatt._build.SIGNATURES[lib]
    tatt.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tatt._call("t", lib, fn, getattr(tatt, wrapper), (q, k, v, do, st, st),
                   (1, 2, 128, 64))
    tatt.causal_mha_small_head_bwd(q, k, v, do, *tatt.causal_mha_small_head_with_stats(
        q, k, v)[1:])
    o, m, l = tatt.flash_causal_attention_with_stats(q, k, v, 128)
    tatt.flash_causal_attention_bwd(q, k, v, o, do, m, l, 128)
    assert all(w.launches == 0 for w in tatt.KERNEL_WRAPPERS)


def test_kernel_wrappers_list_every_launch_counter():
    names = [w.__name__ for w in tatt.KERNEL_WRAPPERS]
    assert names == ["causal_mha_small_head", "flash_causal_attention",
                     "causal_mha_small_head_bwd",
                     "flash_causal_attention_bwd_dkv",
                     "flash_causal_attention_bwd_dq"]
    from incubator_predictionio_tpu_torch.ops import _build

    for fn in ("pio_causal_mha_small_head", "pio_flash_causal",
               "pio_causal_mha_small_head_bwd", "pio_flash_causal_bwd_dkv",
               "pio_flash_causal_bwd_dq"):
        lib = "flash_attention" if "flash" in fn else "attention"
        assert fn in _build.SIGNATURES[lib]
        assert f"int {fn}(" in (_build.CSRC / f"{lib}.cu").read_text()
