"""PyTorch port, the sequential template's training path on the CPU:
``ops/xent.py`` and ``utils/optim.py`` against the JAX package's loss and
``optax.adam``, ``TransformerRecommender.fit`` step for step against the
JAX package's ``fit`` from the same numpy init, ``DataSource._build_fold``,
the cycle-learning band of the reference's template test, and a trained
model's weights served by the JAX package.

Tolerances, with their reasons:
- loss values and gradients: 1e-5 relative. Both packages compute the
  same bf16 logits (the bf16 matmul is bitwise the same on the CPU) and
  reduce them in fp32 in other orders.
- adam: 1e-6 relative on params and ``nu``; ``mu`` stored in bf16 is
  bitwise (optax rounds ``b1·mu`` and the stored moment to nearest even,
  as the port does).
- fit: every step's loss 1e-5 relative (measured: at most 6.4e-6, at the
  second step), the padded two-batch fit's epoch means 1e-4 (measured
  2.7e-5). Layer norm and gelu differ by fp32 ulps between the packages and
  flip bf16 roundings downstream (tests/test_torch_sequential_serving.py).
  The losses after the first step are what holds the gradients: they
  follow from the updates, and a wrong gradient moves them by far more.
  Every parameter stays within 2·lr·steps, a loose band (adam moves an
  element by at most about lr a step, and turns a small gradient
  difference near 0 into a full ±lr step), which checks the tree and the
  layout rather than the gradients.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from incubator_predictionio_tpu.data.bimap import BiMap as JBiMap  # noqa: E402
from incubator_predictionio_tpu.models import transformer as jtr  # noqa: E402
from incubator_predictionio_tpu.ops import xent as jxent  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu.templates import sequential as jseq  # noqa: E402
from incubator_predictionio_tpu_torch.models import transformer as ttr  # noqa: E402
from incubator_predictionio_tpu_torch.ops import xent as txent  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.templates import sequential as tseq  # noqa: E402
from incubator_predictionio_tpu_torch.utils import optim as toptim  # noqa: E402

CPU = DeviceContext.create(device="cpu")
#: the reference template test's cycle data (test_sequential_template.py:25)
N_ITEMS = 12
CYCLE = [f"i{j}" for j in range(N_ITEMS)]
#: the step-parity configuration: one batch of 16 rows, a multiple of the
#: 8 CPU devices of tests/conftest.py, so both packages pad alike
FIT = dict(vocab_size=50, max_len=16, d_model=32, n_heads=2, n_layers=2,
           batch_size=16, epochs=3, learning_rate=1e-3, attention="local")
#: step losses of the port's fit against the JAX package's, relative
STEP_LOSS_RTOL = 1e-5


# -- cross-entropy -------------------------------------------------------------

def _xent_inputs(s, d, v, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(s, d)).astype(np.float32),
            (rng.normal(size=(v, d)) * 0.1).astype(np.float32),
            rng.integers(0, v, s).astype(np.int32),
            (rng.random(s) > 0.2).astype(np.float32))


@pytest.mark.parametrize("path", ["small", "chunked"])
def test_xent_matches_jax_values_and_grads(path):
    """``weighted_xent_sum``'s small path (96 tokens × 37 items) and
    ``chunked_xent_sum`` (chunk 32 over 82 tokens: a padded last chunk)
    against the JAX functions: the value and the gradients in h, w_emb
    and the weights."""
    if path == "small":
        h, w, t, wt = _xent_inputs(96, 16, 37, 0)
        jfn = lambda h, w, wt: jxent.weighted_xent_sum(h, w, jnp.asarray(t), wt)  # noqa: E731
        tfn = lambda h, w, wt: txent.weighted_xent_sum(h, w, torch.from_numpy(t), wt)  # noqa: E731
    else:
        h, w, t, wt = _xent_inputs(82, 8, 23, 2)
        jfn = lambda h, w, wt: jxent.chunked_xent_sum(h, w, jnp.asarray(t), wt, 32)  # noqa: E731
        tfn = lambda h, w, wt: txent.chunked_xent_sum(h, w, torch.from_numpy(t), wt, 32)  # noqa: E731
    want, want_grads = jax.value_and_grad(jfn, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(wt))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (h, w, wt)]
    got = tfn(*leaves)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for name, leaf, g in zip(("h", "w_emb", "weights"), leaves, want_grads):
        g = np.asarray(g)
        assert leaf.grad.shape == g.shape, name
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=name)


def test_weighted_xent_takes_the_reference_threshold():
    """The chunked path above 2^29 logits elements, as the reference; both
    paths compute one loss."""
    assert txent.CHUNKED_THRESHOLD == jxent.CHUNKED_THRESHOLD == 1 << 29
    h, w, t, wt = (torch.from_numpy(a) for a in _xent_inputs(70, 8, 19, 3))
    small = txent.weighted_xent_sum(h, w, t, wt)
    chunked = txent.chunked_xent_sum(h, w, t, wt, 16)
    torch.testing.assert_close(chunked, small, rtol=2e-2, atol=0)


# -- adam ----------------------------------------------------------------------

@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adam_matches_optax(mu_dtype):
    """Five steps of the port's adam against ``optax.adam(lr, mu_dtype)``
    on the same numpy gradients (of several magnitudes)."""
    rng = np.random.default_rng(4)
    shapes = [(7, 5), (13,), (3, 4, 2)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    steps = [[(rng.normal(size=s) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
              for s in shapes] for _ in range(5)]
    opt = optax.adam(1e-2, mu_dtype=jnp.bfloat16 if mu_dtype == "bfloat16" else None)
    jp = [jnp.asarray(a) for a in p0]
    jstate = opt.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    tstate = toptim.adam_init(tp, mu_dtype)
    for g in steps:
        upd, jstate = opt.update([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        toptim.adam_update(tp, [torch.from_numpy(a) for a in g], tstate, 1e-2)
    adam = jstate[0]
    assert tstate.count == int(adam.count) == 5
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=0)
    for a, b in zip(adam.nu, tstate.nu):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=0)
    for a, b in zip(adam.mu, tstate.mu):
        assert str(b.dtype) == f"torch.{mu_dtype}"
        if mu_dtype == "bfloat16":
            np.testing.assert_array_equal(b.float().numpy(),
                                          np.asarray(a.astype(jnp.float32)))
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=0)


def test_adam_refuses_an_unknown_moment_dtype():
    with pytest.raises(ValueError, match="adam_moments_dtype"):
        toptim.adam_init([torch.zeros(2)], "float16")


# -- fit -----------------------------------------------------------------------

def _rows(seed=3, n=16):
    rng = np.random.default_rng(seed)
    seqs = rng.integers(1, FIT["vocab_size"], (n, FIT["max_len"] + 1)).astype(np.int32)
    seqs[: n // 4, :6] = 0  # left-padded sessions
    return seqs


@pytest.fixture()
def same_init(monkeypatch):
    """Both packages start from ``init_params_numpy(cfg, 5)``."""
    init = ttr.init_params_numpy(ttr.TransformerConfig(**FIT), 5)
    monkeypatch.setattr(jtr, "_jit_init_fn", lambda cfg: (
        lambda key: jax.tree.map(jnp.asarray, init)))
    monkeypatch.setattr(ttr, "_init_params",
                        lambda cfg, generator, device: init)
    return init


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_fit_matches_jax_fit_step_for_step(same_init, mu_dtype):
    """One batch for 3 epochs from the same init: every step's loss, the
    final loss and every parameter of the port's ``fit`` against the JAX
    package's. With one batch an epoch, the JAX fit's final loss after e
    epochs is its e-th step's loss."""
    seqs = _rows()
    cfg = dict(FIT, adam_moments_dtype=mu_dtype)
    got = ttr.TransformerRecommender(ttr.TransformerConfig(**cfg)).fit(CPU, seqs, None)
    for epochs in range(1, FIT["epochs"] + 1):
        want = jtr.TransformerRecommender(jtr.TransformerConfig(
            **{**cfg, "epochs": epochs})).fit(MeshContext.create(), seqs, None)
        np.testing.assert_allclose(got.step_losses[epochs - 1, 0], want.final_loss,
                                   rtol=STEP_LOSS_RTOL, err_msg=f"step {epochs}")
    np.testing.assert_allclose(got.final_loss, want.final_loss, rtol=STEP_LOSS_RTOL)
    jflat, jtree = jax.tree.flatten(jax.tree.map(np.asarray, want.params))
    tflat, ttree = jax.tree.flatten(got.params)
    assert jtree == ttree  # the reference's tree, names and shapes
    band = 2 * FIT["learning_rate"] * FIT["epochs"]
    for a, b, p0 in zip(jflat, tflat, jax.tree.flatten(same_init)[0]):
        assert b.dtype == np.float32 and b.shape == a.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=band)
    moved = max(float(np.abs(b - p0).max()) for b, p0 in
                zip(tflat, jax.tree.flatten(same_init)[0]))
    assert moved > FIT["learning_rate"]  # it trained
    assert set(got.timings) == {"train_sec", "gather_sec"}
    assert got.step_losses.shape == (FIT["epochs"], 1)
    np.testing.assert_allclose(got.final_loss, got.step_losses[-1].mean(), rtol=1e-6)


def test_fit_pads_the_last_batch_with_zero_weight_rows(same_init):
    """20 rows at batch 16: two batches, the second padded with 12 zero
    rows of weight 0, in row order — the same losses as the reference, in
    each epoch."""
    seqs = _rows(seed=8, n=20)
    cfg = dict(FIT, epochs=2)
    got = ttr.TransformerRecommender(ttr.TransformerConfig(**cfg)).fit(
        CPU, seqs, None)
    assert got.step_losses.shape == (2, 2)
    for epochs in (1, 2):
        want = jtr.TransformerRecommender(jtr.TransformerConfig(
            **{**cfg, "epochs": epochs})).fit(MeshContext.create(), seqs, None)
        np.testing.assert_allclose(got.step_losses[epochs - 1].mean(),
                                   want.final_loss, rtol=1e-4)
    np.testing.assert_allclose(got.final_loss, want.final_loss, rtol=1e-4)


def test_remat_gives_the_same_params(same_init):
    seqs = _rows()
    plain = ttr.TransformerRecommender(ttr.TransformerConfig(**FIT)).fit(CPU, seqs, None)
    remat = ttr.TransformerRecommender(ttr.TransformerConfig(**FIT, remat=True)).fit(
        CPU, seqs, None)
    assert remat.final_loss == plain.final_loss
    for a, b in zip(jax.tree.flatten(remat.params)[0], jax.tree.flatten(plain.params)[0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rows,vocab,pad", [(1000, 50, 300), (4096, 300, 3000),
                                             (70, 7, 0)])
def test_lookup_backward_is_the_exact_segment_sum(rows, vocab, pad):
    """The lookups' backward (``_Lookup``, which replaced ``F.embedding``'s
    backward: on the card that one summed a repeated index's rows in an
    order that varied from run to run) is the float64 segment sum rounded
    once to float32, bitwise, across the scan's block boundaries and a
    long padding segment. The replaced backward's sequential float32 sums
    lie within their error bound of it: (count − 1)·2⁻²⁴·Σ|g| a table
    element."""
    rng = np.random.default_rng(rows)
    idx = rng.integers(0, vocab, rows)
    idx[:pad] = 0  # the padding token's long segment
    g = rng.standard_normal((rows, 5)).astype(np.float32)
    exact = np.zeros((vocab, 5))
    np.add.at(exact, idx, g.astype(np.float64))
    table = torch.zeros((vocab, 5), requires_grad=True)
    ttr._lookup(torch.from_numpy(idx), table).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(table.grad.numpy(), exact.astype(np.float32))
    old = torch.zeros((vocab, 5), requires_grad=True)
    torch.nn.functional.embedding(torch.from_numpy(idx), old).backward(
        torch.from_numpy(g))
    count = np.bincount(idx, minlength=vocab)[:, None]
    mass = np.zeros((vocab, 5))
    np.add.at(mass, idx, np.abs(g.astype(np.float64)))
    bound = np.maximum(count - 1, 0) * 2.0 ** -24 * mass
    assert (np.abs(old.grad.numpy() - exact) <= bound + 1e-30).all()
    # a scan down more rows than one block's square, in one fixed order
    x = torch.from_numpy(rng.standard_normal((ttr.SCAN_BLOCK ** 2 + 3, 2)))
    np.testing.assert_allclose(ttr._scan_rows(x).numpy(),
                               np.cumsum(x.numpy(), 0), rtol=1e-12, atol=1e-12)
    assert torch.equal(ttr._scan_rows(x), ttr._scan_rows(x))


def test_init_params_draws_the_reference_tree_from_the_seed():
    cfg = ttr.TransformerConfig(**FIT)
    a = ttr._init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = ttr._init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    c = ttr._init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    ref = ttr.init_params_numpy(cfg, 0)
    assert jax.tree.structure(a) == jax.tree.structure(ref)
    for x, y, z, r in zip(*(jax.tree.flatten(t)[0] for t in (a, b, c, ref))):
        assert tuple(x.shape) == r.shape and x.dtype == torch.float32
        assert torch.equal(x, y)
        if float(r.std()) > 0:
            assert not torch.equal(x, z)
            assert 0.8 < float(x.std()) / float(r.std()) < 1.25


@pytest.mark.parametrize("field,value,match", [
    ("attention", "ring", "ring attention"),
    ("n_experts", 4, "mixture-of-experts"),
    ("pipeline_stages", 2, "pipeline"),
    ("tensor_parallel", True, "tensor parallelism"),
    ("checkpoint_dir", "/nonexistent", "checkpoint"),
])
def test_fit_refuses_what_is_not_ported(field, value, match):
    cfg = ttr.TransformerConfig(**{**FIT, field: value})
    if field == "checkpoint_dir":
        # ported (tests/test_torch_checkpoint.py): a directory without
        # checkpoint_every leaves checkpoints off and the directory alone,
        # as the reference's maybe_resume does
        assert np.isfinite(ttr.TransformerRecommender(cfg).fit(
            CPU, _rows(), None).final_loss)
        assert not os.path.exists(value)
        return
    with pytest.raises(NotImplementedError, match=f"{match}.*ROADMAP.md Queue 1, item 4"):
        ttr.TransformerRecommender(cfg).fit(CPU, _rows(), None)


def test_fit_refuses_rows_of_several_processes():
    """Rows of several processes are ported (the data-parallel fit,
    tests/test_torch_distributed_eval.py): a context that claims two
    processes without a group refuses at its first collective, the
    staging's; checkpoints of a multi-process fit name item 4.3."""
    ctx = DeviceContext(torch.device("cpu"), process_index=0, process_count=2)
    # the data axis is the process count (one device a process)
    assert ctx.pad_to_batch_multiple(13) == 14
    for local in (True, False):
        with pytest.raises(RuntimeError, match="no process group was joined"):
            ttr.TransformerRecommender(ttr.TransformerConfig(**FIT)).fit(
                ctx, _rows(), None, rows_are_local=local)
    with pytest.raises(NotImplementedError, match="item 4.3.*ROADMAP.md Queue 1"):
        ttr.TransformerRecommender(ttr.TransformerConfig(
            **FIT, checkpoint_dir="/nonexistent", checkpoint_every=1)).fit(
            ctx, _rows(), None, rows_are_local=True)
    with pytest.raises(ValueError, match="max_len"):
        ttr.TransformerRecommender(ttr.TransformerConfig(**FIT)).fit(
            CPU, _rows()[:, :10], None)


# -- template ------------------------------------------------------------------

def _cycle_sessions():
    """test_sequential_template.py:25-44's sessions, without the event
    store: 48 users walking the 12-item cycle from a random start."""
    rng = np.random.default_rng(9)
    out = []
    for _ in range(48):
        start = int(rng.integers(0, N_ITEMS))
        length = int(rng.integers(5, 12))
        out.append([CYCLE[(start + step) % N_ITEMS] for step in range(length)])
    return out


def test_build_fold_matches_jax():
    sessions = _cycle_sessions()[:10] + [["i3"], [], ["x", "i3", "y"]]
    params = dict(app_name="seq-test", max_len=16)
    want = jseq.DataSource(jseq.DataSourceParams(**params))._build_fold(
        MeshContext.create(), sessions, False)
    got = tseq.DataSource(tseq.DataSourceParams(**params))._build_fold(
        CPU, sessions, False)
    assert dict(got.item_map.items()) == dict(want.item_map.items())
    np.testing.assert_array_equal(got.sequences, want.sequences)
    # rows of at least 2 items: the 10 cycle sessions and [x, i3, y]
    assert got.sequences.shape == (11, 17) and 0 not in set(got.item_map.values())
    assert not got.rows_are_local and got.n_rows_global is None
    got.sanity_check()
    with pytest.raises(ValueError, match="no sessions"):
        tseq.DataSource(tseq.DataSourceParams(**params))._build_fold(
            CPU, [["i1"]], False).sanity_check()
    # the sharded branch on one process: the union over one shard is the
    # shard's own vocabulary, the rows local and counted
    want = jseq.DataSource(jseq.DataSourceParams(**params))._build_fold(
        MeshContext.create(), sessions, True)
    got = tseq.DataSource(tseq.DataSourceParams(**params))._build_fold(
        CPU, sessions, True)
    assert dict(got.item_map.items()) == dict(want.item_map.items())
    np.testing.assert_array_equal(got.sequences, want.sequences)
    assert got.rows_are_local and want.rows_are_local
    assert got.n_rows_global == want.n_rows_global == 11


@pytest.fixture(scope="module")
def cycle_model():
    """The reference template test's training (test_sequential_template.py:47
    ``algo_params``, local attention, 60 epochs) through the port's
    ``TransformerAlgorithm.train``."""
    td = tseq.DataSource(tseq.DataSourceParams(app_name="seq-test", max_len=16)) \
        ._build_fold(CPU, _cycle_sessions(), False)
    algo = tseq.TransformerAlgorithm(tseq.TransformerAlgorithmParams(
        app_name="seq-test", max_len=16, d_model=32, n_heads=2, n_layers=2,
        learning_rate=3e-3, batch_size=64, epochs=60, attention="local"))
    return algo, algo.train(CPU, td)


def test_trained_model_learns_the_cycle(cycle_model):
    """The reference's quality band (test_sequential_template.py:95):
    ≥ 10 of 12 next items right after a 4-item history."""
    algo, model = cycle_model
    model.prepare_for_serving(CPU)
    queries = [(s, tseq.Query(recent_items=tuple(CYCLE[(s + j) % N_ITEMS]
                                                 for j in range(4)), num=1))
               for s in range(N_ITEMS)]
    hits = sum(int(r.item_scores and r.item_scores[0].item == CYCLE[(s + 4) % N_ITEMS])
               for s, r in algo.batch_predict(model, queries))
    assert hits >= 10, f"cycle prediction hits {hits}/12"
    assert np.isfinite(model.final_loss) and model.step_losses[-1, 0] < model.step_losses[0, 0]
    assert model.config.vocab_size == N_ITEMS + 1


def test_trained_weights_serve_in_the_jax_package(cycle_model):
    """A port-trained model's params load into the JAX package's
    ``_serve_scores`` unchanged; the scores agree with the port's
    ``next_item_scores`` within the serving tolerance, 1e-2 — absolute,
    and relative too: the trained model's scores reach |4-8|, where one
    bf16 step of the served scores is 0.03."""
    _, model = cycle_model
    model.prepare_for_serving(CPU)
    rng = np.random.default_rng(1)
    rows = rng.integers(1, N_ITEMS + 1, (5, 16)).astype(np.int32)
    rows[:2, :9] = 0
    jcfg = jtr.TransformerConfig(vocab_size=N_ITEMS + 1, max_len=16, d_model=32,
                                 n_heads=2, n_layers=2)
    jm = jtr.TransformerModel(jax.tree.map(jnp.asarray, model.params),
                              JBiMap(dict(model.item_map.items())), jcfg)
    want = jtr.TransformerRecommender.next_item_scores(jm, rows)
    got = ttr.TransformerRecommender.next_item_scores(model, rows)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)
