"""PyTorch port, ops/attention.py + parallel/ring.py: the plain versions of
kernels K4 (small-head causal MHA) and K5 (causal flash attention), the
port's ``causal_attention_reference`` and its routing, held against the JAX
package on the same numpy inputs.

Tolerances: 2e-2 absolute and relative, the reference's own kernel-vs-oracle
tolerance (tests/test_small_head_attention.py:34, tests/test_ring_attention.py:90):
the operands are bf16 and the outputs are rounded to bf16, whose spacing is
1.6e-2 at the |values| of 2-4 that these normal inputs reach; the two
packages round ``p`` to bf16 at different places (normalised or not, against
different running maxes). Where the two compute the same function in the
same order (the CPU routing of ``causal_attention``), equality is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.ops import attention as jatt  # noqa: E402
from incubator_predictionio_tpu.parallel import ring as jring  # noqa: E402
from incubator_predictionio_tpu_torch.ops import attention as tatt  # noqa: E402
from incubator_predictionio_tpu_torch.parallel import ring as tring  # noqa: E402

TOL = 2e-2


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(3))


def _torch_bf16(*arrays):
    return tuple(torch.from_numpy(a).to(torch.bfloat16).contiguous()
                 for a in arrays)


@pytest.mark.parametrize("b,l,h,d", [(2, 128, 4, 64), (1, 256, 2, 64),
                                     (3, 128, 8, 128)])
def test_small_head_plain_matches_jax_kernel_interpret(b, l, h, d):
    """K4's plain version against the JAX Pallas kernel in interpret mode,
    at the shapes of tests/test_small_head_attention.py:24."""
    q, k, v = _qkv((b, h, l, d), seed=l + d)
    want = np.asarray(jatt.causal_mha_small_head(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), True
    ).astype(jnp.float32))
    got = tatt.causal_mha_small_head(*_torch_bf16(q, k, v))
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, l, d)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("l", [128, 256, 512])
def test_flash_plain_matches_jax_reference(l, d):
    """K5's plain version (at the reference's flash block, 128 where L is
    too short for one) against the JAX ``causal_attention_reference``."""
    q, k, v = _qkv((2, l, 2, d), seed=3 * l + d)
    want = np.asarray(jring.causal_attention_reference(
        *(jnp.asarray(x) for x in (q, k, v))))
    block = tring.flash_block_size(l) or 128
    got = tatt.flash_causal_attention(
        *(x.transpose(1, 2).contiguous() for x in _torch_bf16(q, k, v)), block)
    np.testing.assert_allclose(got.transpose(1, 2).float().numpy(), want,
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("l", [128, 256, 512])
def test_port_reference_matches_jax_reference(l, d):
    """The port's ``causal_attention_reference`` against the JAX one. Both
    sum bf16 products in fp32 and run the softmax in fp32; they differ only
    in fp32 summation order, and in the bf16 roundings of ``p`` that order
    flips — far inside the kernel tolerance."""
    q, k, v = _qkv((2, l, 2, d), seed=5 * l + d)
    want = np.asarray(jring.causal_attention_reference(
        *(jnp.asarray(x) for x in (q, k, v))))
    got = tring.causal_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("l", [32, 129, 512])
def test_causal_attention_on_cpu_is_the_reference(l):
    """On CPU tensors ``causal_attention`` IS the reference (the counterpart
    of tests/test_ring_attention.py:110) — exact equality, whatever the
    CUDA route of the shape would be."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((2, l, 2, 64), seed=l))
    torch.testing.assert_close(tring.causal_attention(q, k, v),
                               tring.causal_attention_reference(q, k, v),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kernel", ["small_head", "flash"])
def test_plain_versions_are_causal(kernel):
    """Changing future keys and values leaves past outputs unchanged."""
    q, k, v = _torch_bf16(*_qkv((1, 2, 256, 64), seed=8))
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 130:] = 9.0
    v2[:, :, 130:] = -7.0

    def run(k_, v_):
        if kernel == "small_head":
            return tatt.causal_mha_small_head(q, k_, v_)
        return tatt.flash_causal_attention(q, k_, v_, 128)

    a, b = run(k, v), run(k2, v2)
    torch.testing.assert_close(a[:, :, :130], b[:, :, :130], rtol=0, atol=0)
    assert not torch.equal(a[:, :, 130:], b[:, :, 130:])


def test_small_head_and_flash_plain_versions_agree():
    """K4's and K5's plain versions compute the same function in two
    rounding orders."""
    q, k, v = _torch_bf16(*_qkv((2, 4, 512, 64), seed=21))
    torch.testing.assert_close(
        tatt.flash_causal_attention(q, k, v, 512).float(),
        tatt.causal_mha_small_head(q, k, v).float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("l", [64, 100, 128, 256, 384, 512, 640, 768, 1024,
                               2048, 8192])
def test_routing_predicates_are_the_reference_copies(l):
    """``fits_small_head_kernel`` and ``flash_block_size`` equal the
    reference's over a grid of (B, L, H, D)."""
    assert tring.flash_block_size(l) == jring.flash_block_size(l)
    for b in (1, 8, 64):
        for h in (1, 2, 8, 16):
            for d in (16, 32, 48, 64, 128):
                assert (tatt.fits_small_head_kernel(b, l, h, d)
                        == jatt.fits_small_head_kernel(b, l, h, d)), (b, l, h, d)


@pytest.mark.parametrize("shape,route", [
    ((64, 512, 8, 64), "small_head"),   # bench_sequential's serving shape
    ((64, 1024, 8, 64), "flash"),       # the same widths at max_len 1024
    ((8, 768, 8, 64), "flash"),         # over K4's 12 MB budget
    ((8, 640, 8, 64), "small_head"),    # 11.1 MB: still K4
    ((8, 640, 8, 32), "flash"),         # d % 64 != 0
    ((8, 512, 8, 32), "flash"),
    ((3, 128, 8, 128), "small_head"),
    ((64, 100, 8, 64), "reference"),    # tile-unaligned
    ((8, 128, 4, 32), "reference"),     # too short for a flash block
])
def test_cuda_route_matches_the_reference_decision(shape, route):
    assert tring.attention_route(*shape) == route


def _bad_inputs():
    good = _torch_bf16(*_qkv((1, 2, 128, 64), seed=1))
    q, k, v = good
    return {
        "dtype": ((q.float(), k, v), TypeError, "bfloat16"),
        "shape": ((q, k[:, :, :64], v), ValueError, "shape"),
        "rank": ((q[0], k[0], v[0]), ValueError, r"\[B, H, L, D\]"),
        "layout": ((q.transpose(2, 3).contiguous().transpose(2, 3), k, v),
                   ValueError, "contiguous"),
        "head_dim": (_torch_bf16(*_qkv((1, 2, 128, 48), seed=2)),
                     ValueError, "head dim"),
        "length": (_torch_bf16(*_qkv((1, 2, 96, 64), seed=3)),
                   ValueError, "multiple"),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
@pytest.mark.parametrize("kernel", ["small_head", "flash"])
def test_wrappers_refuse_what_the_kernel_does_not_take(kernel, case):
    args, exc, match = _bad_inputs()[case]
    with pytest.raises(exc, match=match):
        if kernel == "small_head":
            tatt.causal_mha_small_head(*args)
        else:
            tatt.flash_causal_attention(*args, 64)


def test_flash_block_must_divide_the_sequence():
    q, k, v = _torch_bf16(*_qkv((1, 1, 384, 64), seed=4))
    with pytest.raises(ValueError, match="block"):
        tatt.flash_causal_attention(q, k, v, 256)


@pytest.mark.parametrize("fn", ["pio_causal_mha_small_head", "pio_flash_causal"])
def test_launcher_refuses_cpu_tensors(fn):
    """The launch path never takes a CPU tensor (no plain-version fallback
    behind it), and a refused call counts no launch."""
    lib = {"pio_causal_mha_small_head": "attention",
           "pio_flash_causal": "flash_attention"}[fn]  # K4's source, K5's
    assert fn in tatt._build.SIGNATURES[lib]
    q, k, v = _torch_bf16(*_qkv((1, 1, 128, 64), seed=5))
    tatt.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tatt._launch("t", lib, fn, tatt.causal_mha_small_head, q, k, v)
    assert tatt.causal_mha_small_head.launches == 0
    # the plain versions on the CPU count no launch either
    tatt.causal_mha_small_head(q, k, v)
    tatt.flash_causal_attention(q, k, v, 128)
    assert all(w.launches == 0 for w in tatt.KERNEL_WRAPPERS)
