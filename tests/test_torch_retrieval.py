"""PyTorch port, ops/retrieval.py: the plain versions of kernels K1 and K2
against the JAX package's Pallas kernels (interpret mode) and jnp oracles
on the same numpy inputs, plus the quantization and padding helpers.

The CUDA kernels themselves run only on a card (chip_smoke.py holds them
against these plain versions there); here the wrappers must take the plain
version for CPU tensors and the launchers must refuse CPU tensors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from incubator_predictionio_tpu.ops import retrieval as jr  # noqa: E402
from incubator_predictionio_tpu_torch.ops import retrieval as tr  # noqa: E402

#: the reference's own kernel-vs-oracle tolerance (test_retrieval_kernel.py:42)
K1_TOL = 2e-2
#: what the plain version actually reaches: the products are exact and only
#: the fp32 summation order differs from the reference's
K1_ROUNDOFF = 1e-4


def _catalog(b, d, n_real, seed, row_mask=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, d)).astype(np.float32)
    items = rng.normal(size=(n_real, d)).astype(np.float32)
    items_q, scales = jr.quantize_rows(items)
    bias = rng.normal(size=n_real).astype(np.float32)
    mask = np.zeros(n_real, np.float32)
    mask[[3, min(77, n_real - 1)]] = -np.inf
    items_q, scales, bias, mask = jr.pad_catalog(items_q, scales, bias, mask)
    rm = None
    if row_mask:
        rm = np.zeros((b, items_q.shape[0]), np.float32)
        rm[np.arange(b), rng.integers(0, n_real, b)] = -np.inf
    return q, items_q, scales, bias, mask, rm


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


def _jnp(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _assert_close_with_infs(got, want, rtol, atol):
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=atol)
    return float(np.abs(got[finite] - want[finite]).max())


@pytest.mark.parametrize("row_mask", [False, True], ids=["plain", "row_mask"])
@pytest.mark.parametrize("b,d,n", [(8, 32, 1000), (3, 128, 700), (16, 32, 4096),
                                   # the top serving bucket (the kernel loops
                                   # over 64-query tiles); a D that pads K
                                   (256, 32, 600), (5, 40, 900)])
def test_k1_plain_matches_jax_kernel_and_oracle(b, d, n, row_mask):
    args = _catalog(b, d, n, seed=b + d, row_mask=row_mask)
    got = tr.score_catalog_quantized(*_torch(*args)).numpy()
    want_kernel = np.asarray(jr.score_catalog_quantized(
        *_jnp(*args), interpret=True))
    want_ref = np.asarray(jr.score_catalog_reference(*_jnp(*args)))
    for want in (want_kernel, want_ref):
        _assert_close_with_infs(got, want, K1_TOL, K1_TOL)
        err = _assert_close_with_infs(got, want, K1_ROUNDOFF, K1_ROUNDOFF)
        assert err <= K1_ROUNDOFF
    # the wrapper took the plain version: no kernel launch on the CPU
    assert tr.score_catalog_quantized.launches == 0


@pytest.mark.parametrize("b,d,c", [(8, 24, 517), (32, 32, 1000),
                                   (16, 128, 512)])
def test_k2_plain_matches_jax_kernel_and_host(b, d, c):
    rng = np.random.default_rng(c)
    cent_q, cent_s = jr.quantize_rows(rng.normal(size=(c, d)).astype(np.float32))
    cent_b = rng.normal(size=c).astype(np.float32)
    q_q, q_s = jr.quantize_rows(rng.normal(size=(b, d)).astype(np.float32))
    cq, cs, cb = jr.pad_centroids(cent_q, cent_s, cent_b)
    got = tr.score_centroids_quantized(*_torch(q_q, q_s, cq, cs, cb)).numpy()
    want = np.asarray(jr.score_centroids_quantized(
        *_jnp(q_q, q_s, cq, cs, cb), interpret=True))
    # the reference's kernel tolerance (test_retrieval_kernel.py:291)
    _assert_close_with_infs(got, want, 3e-7, 1e-6)
    # and the host probe math, to the byte
    host = (jr.int8_matmul_exact(q_q, cent_q)
            * (q_s[:, None] * cent_s[None, :]) + cent_b[None, :])
    np.testing.assert_array_equal(got[:, :c], host)
    assert np.isneginf(got[:, c:]).all()
    assert tr.score_centroids_quantized.launches == 0


@pytest.mark.parametrize("n,d", [(700, 32), (1024, 128), (5, 8)])
def test_quantization_and_padding_bitwise(n, d):
    rng = np.random.default_rng(n)
    items = (rng.normal(size=(n, d)) * rng.uniform(0.01, 10, (n, 1))
             ).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    q_t, s_t = tr.quantize_rows(items)
    q_j, s_j = jr.quantize_rows(items)
    np.testing.assert_array_equal(q_t, q_j)
    np.testing.assert_array_equal(s_t, s_j)
    dev = [t.numpy() for t in tr.quantize_catalog_device(
        torch.from_numpy(items), torch.from_numpy(bias))]
    padded_t = tr.pad_catalog(q_t, s_t, bias, np.zeros(n, np.float32))
    padded_j = jr.pad_catalog(q_j, s_j, bias, np.zeros(n, np.float32))
    for a, b, c in zip(dev, padded_t, padded_j):
        np.testing.assert_array_equal(b, c)
        # the port's device quantization IS the host quantize_rows + padding
        # (the reference's path for host models, two_tower.py:335-339)
        assert a.dtype == c.dtype and a.shape == c.shape
        np.testing.assert_array_equal(a, c)
    # the reference's own jitted device version: XLA turns the division by
    # 127 into a multiply by its reciprocal, so its scales sit within 1 ulp
    # of quantize_rows'; the int8 rows, bias and mask agree bitwise
    ref = [np.asarray(a) for a in jr.quantize_catalog_device(
        jnp.asarray(items), jnp.asarray(bias))]
    for i, (a, b) in enumerate(zip(dev, ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if i == 1:
            ulps = np.abs(a.view(np.int32).astype(np.int64)
                          - b.view(np.int32).astype(np.int64))
            assert ulps.max() <= 1
        else:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tr.pad_centroids(q_t, s_t, bias),
                    jr.pad_centroids(q_j, s_j, bias)):
        np.testing.assert_array_equal(a, b)
    a8 = rng.integers(-127, 128, (9, d)).astype(np.int8)
    np.testing.assert_array_equal(tr.int8_matmul_exact(a8, q_t),
                                  jr.int8_matmul_exact(a8, q_j))


def test_launchers_refuse_cpu_tensors():
    args = _torch(*_catalog(4, 32, 512, seed=1)[:5])
    with pytest.raises(ValueError, match="CUDA tensor"):
        tr._launch_score_catalog(*args)
    q_q, q_s = tr.quantize_rows(np.ones((8, 32), np.float32))
    cq, cs = tr.quantize_rows(np.ones((512, 32), np.float32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tr._launch_score_centroids(*_torch(q_q, q_s, cq, cs,
                                           np.zeros(512, np.float32)))
    assert tr.score_catalog_quantized.launches == 0
    assert tr.score_centroids_quantized.launches == 0


def test_wrappers_check_shapes_like_the_reference():
    q, items_q, scales, bias, mask, _ = _catalog(4, 32, 512, seed=2)
    with pytest.raises(ValueError, match="padded"):
        tr.score_catalog_quantized(*_torch(q, items_q[:500], scales[:500],
                                           bias[:500], mask[:500]))
    with pytest.raises(ValueError, match="row_mask"):
        tr.score_catalog_quantized(*_torch(q, items_q, scales, bias, mask,
                                           np.zeros((3, 512), np.float32)))
    q_q, q_s = tr.quantize_rows(q)
    with pytest.raises(ValueError, match="padded"):
        tr.score_centroids_quantized(*_torch(q_q, q_s, items_q[:500],
                                             scales[:500], bias[:500]))


def test_kernel_source_and_build_need_no_nvcc_at_import(tmp_path):
    from incubator_predictionio_tpu_torch.ops import _build

    src = _build.CSRC / "retrieval.cu"
    assert src.exists()
    text = src.read_text()
    for fn in _build.SIGNATURES["retrieval"]:
        assert f"{fn}(" in text
    # content-keyed: the library name follows the source and the flags
    assert _build.library_path("retrieval").name.startswith("libretrieval-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("b,d", [(1, 32), (8, 32), (50, 32), (64, 32),
                                 (200, 32), (3, 24), (9, 40)])
def test_packed_probe_batch_unpacks_to_the_padded_queries(b, d):
    """K2's packed probe batch (one buffer, one copy to the card) unpacks
    to the bucket-padded ``q_q`` and scales, bitwise: zero rows and zero
    scales past ``b``, the scales 16-byte aligned after the queries."""
    rng = np.random.default_rng(b * d)
    q_q, q_s = tr.quantize_rows(rng.normal(size=(b, d)).astype(np.float32))
    bp = tr.probe_bucket(b)
    assert bp >= max(8, b) and bp & (bp - 1) == 0 and bp < 2 * max(8, b)
    want_q = np.zeros((bp, d), np.int8)
    want_q[:b] = q_q
    want_s = np.zeros(bp, np.float32)
    want_s[:b] = q_s
    # a dirty, oversized staging buffer: the padding must be rewritten
    stage = torch.full((tr.probe_packed_bytes(b, d) + 64,), 0xAB,
                       dtype=torch.uint8)
    packed = tr.pack_probe_queries(q_q, q_s, stage)
    assert packed.numel() == tr.probe_packed_bytes(b, d)
    assert packed.data_ptr() == stage.data_ptr()
    got_q, got_s = tr.unpack_probe_queries(packed, b, d)
    assert got_q.dtype == torch.int8 and tuple(got_q.shape) == (bp, d)
    assert got_s.dtype == torch.float32 and tuple(got_s.shape) == (bp,)
    assert got_q.numpy().tobytes() == want_q.tobytes()
    assert got_s.numpy().tobytes() == want_s.tobytes()
    assert (got_s.data_ptr() - packed.data_ptr()) % 16 == 0


def test_staged_probe_path_equals_the_host_probe():
    """``IVFIndex._probe_cuda``'s path (the packed staging buffer, K2's
    wrapper, the copy down) run on a CPU-device index takes K2's plain
    version: its coarse scores and probe sets equal the host probe's,
    bitwise, batch after batch through the reused buffer."""
    from incubator_predictionio_tpu_torch.serving import ann

    rng = np.random.default_rng(3)
    items = rng.normal(size=(3000, 16)).astype(np.float32)
    ivf = ann.build_ivf(items, rng.normal(size=3000).astype(np.float32))
    cent_q, cent_s = ivf._coarse_quant()
    for b in (5, 64, 9):
        q_q, q_s = tr.quantize_rows(rng.normal(size=(b, 16)).astype(np.float32))
        host = (tr.int8_matmul_exact(q_q, cent_q)
                * (q_s[:, None] * cent_s[None, :]) + ivf.centroids[:, -1][None, :])
        ivf.device = torch.device("cpu")
        got = ivf._probe_cuda(q_q, q_s)
        assert got.shape == (b, ivf.n_partitions)
        assert got.tobytes() == host.astype(np.float32).tobytes()
        ivf.device = None
        nprobe = 4
        want = ivf.probe(np.zeros((b, 16), np.float32), nprobe, (q_q, q_s))
        np.testing.assert_array_equal(
            np.sort(np.argpartition(-got, nprobe - 1, axis=1)[:, :nprobe], 1),
            np.sort(want, 1))
    assert tr.score_centroids_quantized.launches == 0
