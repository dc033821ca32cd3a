"""PyTorch port, kernel K5 (causal flash attention) in its own source,
``csrc/flash_attention.cu``: the build table names exactly the functions
each CUDA source exports, the wrappers send K4 and K5 to their own
libraries, and the plain versions that the kernel is held against on the
card do not depend on the tile width (the kernel walks 64-key tiles and
128-row query tiles, the reference 512-wide blocks) nor on L being a
multiple of 128.

Tolerances: 2e-2 absolute and relative for outputs, 2e-2 of each
gradient's max abs for gradients — the reference's own
(tests/test_small_head_attention.py:34, :55-58). Two block widths round
``p`` to bf16 against other running maxes, and sum the blocks' products in
another order.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.parallel import ring as jring  # noqa: E402
from incubator_predictionio_tpu_torch.ops import _build  # noqa: E402
from incubator_predictionio_tpu_torch.ops import attention as tatt  # noqa: E402

TOL = 2e-2
SOURCES = ("attention", "flash_attention", "retrieval", "sparse_update")


def _bf16(shape, seed, n):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(torch.bfloat16).contiguous() for _ in range(n))


def _exported(name: str) -> list[str]:
    """The functions defined in the ``extern "C"`` block of csrc/<name>.cu,
    parsed from the source text."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    block = text.split('extern "C" {', 1)[1].split('}  // extern "C"', 1)[0]
    return re.findall(r"^[A-Za-z_][\w\s\*]*?\b(pio_\w+)\(", block, re.M)


def test_every_source_has_a_signature_table():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(SOURCES)
    assert sorted(_build.SIGNATURES) == sorted(SOURCES)


@pytest.mark.parametrize("name", SOURCES)
def test_signatures_name_exactly_the_exported_functions(name):
    """``_build.SIGNATURES`` names every ``extern "C"`` function of the
    source, and nothing else: a function missing there would load without
    its argument types (ctypes would cut the pointers)."""
    exported = _exported(name)
    assert len(exported) == len(set(exported)), exported
    assert sorted(exported) == sorted(_build.SIGNATURES[name])
    assert "pio_error_string" in exported


def test_k5_lives_in_its_own_source():
    assert sorted(_exported("flash_attention")) == [
        "pio_error_string", "pio_flash_causal", "pio_flash_causal_bwd_dkv",
        "pio_flash_causal_bwd_dq"]
    assert not any("flash" in f for f in _exported("attention"))


def test_wrappers_route_each_kernel_to_its_library(monkeypatch):
    """Off the CPU every wrapper launches through ``_call`` with its
    library: K4 from ``attention``, K5 from ``flash_attention``. Tensors on
    the meta device take the launch path without a card; the recording
    ``_call`` launches nothing."""
    calls = []
    monkeypatch.setattr(tatt, "_call", lambda what, lib, fn, wrapper, tensors, shape:
                        calls.append((lib, fn, wrapper.__name__, tuple(shape))))
    q, k, v, do = (torch.empty((2, 2, 128, 64), dtype=torch.bfloat16, device="meta")
                   for _ in range(4))
    st = torch.empty((2, 2, 128), device="meta")
    tatt.reset_launches()
    tatt.causal_mha_small_head(q, k, v)
    tatt.causal_mha_small_head_bwd(q, k, v, do, st, st)
    tatt.flash_causal_attention(q, k, v, 128)
    tatt.flash_causal_attention_with_stats(q, k, v, 64)
    tatt.flash_causal_attention_bwd(q, k, v, q, do, st, st, 128)
    assert calls == [
        ("attention", "pio_causal_mha_small_head", "causal_mha_small_head", (2, 2, 128, 64)),
        ("attention", "pio_causal_mha_small_head_bwd", "causal_mha_small_head_bwd",
         (2, 2, 128, 64)),
        ("flash_attention", "pio_flash_causal", "flash_causal_attention", (2, 2, 128, 64)),
        ("flash_attention", "pio_flash_causal", "flash_causal_attention", (2, 2, 128, 64)),
        ("flash_attention", "pio_flash_causal_bwd_dkv", "flash_causal_attention_bwd_dkv",
         (2, 2, 128, 64)),
        ("flash_attention", "pio_flash_causal_bwd_dq", "flash_causal_attention_bwd_dq",
         (2, 2, 128, 64)),
    ]
    for lib, fn, _, _ in calls:
        assert fn in _build.SIGNATURES[lib]
    assert all(w.launches == 0 for w in tatt.KERNEL_WRAPPERS)


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("l", [512, 1024])
def test_flash_plain_forward_is_free_of_the_block_width(l, block):
    """K5's plain forward at the kernel's key-tile widths agrees with the
    reference's 512-wide blocks; the row statistics are the same function
    of the scores at every width."""
    q, k, v = _bf16((1, 2, l, 64), seed=l + block, n=3)
    o, m, den = tatt._flash_reference(q, k, v, block)
    o_ref, m_ref, den_ref = tatt._flash_reference(q, k, v, 512)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(m, m_ref, atol=0, rtol=0)
    torch.testing.assert_close(den, den_ref, atol=0, rtol=1e-5)


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("l", [512, 1024])
def test_flash_plain_backward_is_free_of_the_block_width(l, block):
    q, k, v, do = _bf16((1, 2, l, 64), seed=3 * l + block, n=4)
    grads = []
    for blk in (block, 512):
        o, m, den = tatt._flash_reference(q, k, v, blk)
        grads.append(tatt.flash_causal_attention_bwd_reference(q, k, v, o, do, m,
                                                               den, blk))
    for name, g, w in zip(("dq", "dk", "dv"), *grads):
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=TOL * scale, rtol=0,
                                   msg=name)


def test_l576_is_in_the_contract_and_matches_the_jax_reference():
    """L a multiple of 64 but not of 128 (the kernel's ragged last query
    tile) is accepted with 64-wide blocks, and the plain forward and
    backward agree with the JAX ``causal_attention_reference`` and its
    gradient."""
    b, h, l, d = 2, 2, 576, 64
    rng = np.random.default_rng(576)
    q, k, v, do = (np.array(jnp.asarray(rng.normal(size=(b, l, h, d)), jnp.bfloat16)
                            .astype(jnp.float32)) for _ in range(4))
    want, vjp = jax.vjp(jring.causal_attention_reference,
                        *(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt, dot = (torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2).contiguous()
                       for x in (q, k, v, do))
    with pytest.raises(ValueError, match="block"):
        tatt.flash_causal_attention(qt, kt, vt, 128)
    o, m, den = tatt.flash_causal_attention_with_stats(qt, kt, vt, 64)
    np.testing.assert_allclose(o.transpose(1, 2).float().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)
    got = tatt.flash_causal_attention_bwd(qt, kt, vt, o, dot, m, den, 64)
    for name, g, w in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(do))):
        w = np.asarray(w).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(g.float().numpy(), w, atol=TOL * np.abs(w).max(),
                                   rtol=0, err_msg=name)
