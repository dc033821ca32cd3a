"""PyTorch port, mid-training checkpoints (``utils/checkpoint.py``) on the
CPU: the port's counterparts of tests/test_checkpoint.py (:17, :36, :56,
:68, :87, :103, :114, :181), each resumed fit held **bitwise** against the
port's uninterrupted fit from the same init, and the port's resumed
two-tower fit held against the JAX package's uninterrupted fit in
tests/test_torch_two_tower_training.py's 3-epoch bands (loss 1e-4
relative, tables 1e-2 relative Frobenius).
"""

import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_tpu.models import two_tower as jtt  # noqa: E402
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu_torch import convert  # noqa: E402
from incubator_predictionio_tpu_torch.models import transformer as ttr  # noqa: E402
from incubator_predictionio_tpu_torch.models import two_tower as ttt  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.utils import optim  # noqa: E402
from incubator_predictionio_tpu_torch.utils.checkpoint import (  # noqa: E402
    TrainCheckpointer,
    maybe_resume,
    scalar,
)

CPU = DeviceContext.create(device="cpu")
TABLES = ("user_emb", "item_emb", "user_bias", "item_bias")
LOSS_RTOL, TABLE_RTOL = 1e-4, 1e-2


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_roundtrip_and_retention(tmp_path, moments):
    """Both adams' states come back bitwise, moments in their dtype, the
    step count exact; the scratch tables are not written; max_to_keep
    drops the oldest step."""
    params = [torch.arange(6, dtype=torch.float32).reshape(2, 3),
              torch.linspace(-1, 1, 3)]
    tree = optim.adam_tree_init(params, moments)
    opt = optim.adam_init(params, moments)
    for _ in range(3):
        grads = [torch.sin(p * 3 + 1) for p in params]
        optim.adam_update(params, grads, opt, 1e-2)
        optim.adam_apply(params, [g.clone() for g in grads], tree, 1e-2)
    assert tree.scratch  # made at the first step
    with TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=2) as ck:
        assert ck.latest_step() is None
        for step in (1, 2, 3):
            ck.save(step, {"params": params, "opt": opt, "tree": tree,
                           "epoch": scalar(step)})
        assert ck.latest_step() == 3
        assert ck.all_steps() == [2, 3]
        assert sorted(os.listdir(ck.directory)) == ["step-2.pt", "step-3.pt"]
        like_p = [torch.zeros_like(p) for p in params]
        like = {"params": like_p, "opt": optim.adam_init(like_p, moments),
                "tree": optim.adam_tree_init(like_p, moments),
                "epoch": scalar(0)}
        state = ck.restore(like=like)
    assert int(state["epoch"]) == 3
    assert state["params"][0] is like_p[0]  # copied into the template's tensors
    for a, b in zip(state["params"], params):
        _same_bits(a, b)
    assert type(state["opt"]) is optim.AdamState and state["opt"].count == 3
    assert type(state["tree"]) is optim.AdamTreeState and state["tree"].count == 3
    assert state["tree"].scratch == []
    for got, want in ((state["opt"].mu, opt.mu), (state["opt"].nu, opt.nu),
                      (state["tree"].m, tree.m), (state["tree"].v, tree.v)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
    plain = TrainCheckpointer(str(tmp_path / "ck")).restore(2)
    assert int(plain["epoch"]) == 2 and plain["tree"]["count"] == 3


def test_restore_missing_raises(tmp_path):
    with TrainCheckpointer(str(tmp_path / "empty")) as ck:
        with pytest.raises(FileNotFoundError):
            ck.restore()


def test_failed_restore_leaves_the_template_alone(tmp_path):
    ck = TrainCheckpointer(str(tmp_path / "ck"))
    ck.save(1, {"params": [torch.ones(3), torch.ones(2)], "epoch": scalar(1)})
    like = {"params": [torch.zeros(3), torch.zeros(4)], "epoch": scalar(0)}
    with pytest.raises(ValueError, match=r"params'\]\[1\]"):
        ck.restore(like=like)
    assert not like["params"][0].any()


def _data(n_users=40, n=512, n_items=30, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n).astype(np.int32),
            rng.integers(0, n_items, n).astype(np.int32),
            (1 + 4 * rng.random(n)).astype(np.float32), n_users, n_items)


def _fit_two_tower(ckpt_dir, epochs, every, n_users=40, moments="float32"):
    """Every fit starts from the same tables: the port's init draws from
    ``seed``."""
    users, items, ratings, nu, ni = _data(n_users)
    cfg = ttt.TwoTowerConfig(rank=8, epochs=epochs, batch_size=128, seed=3,
                             checkpoint_dir=ckpt_dir, checkpoint_every=every,
                             adam_moments_dtype=moments, gather="host")
    return ttt.TwoTowerMF(cfg).fit(CPU, users, items, ratings, nu, ni)


def _same_model(got, want):
    for name in TABLES:
        _same_bits(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_two_tower_resume_matches_uninterrupted(tmp_path, moments):
    straight = _fit_two_tower(None, epochs=4, every=0, moments=moments)
    partial = _fit_two_tower(str(tmp_path / "tt"), epochs=2, every=2,
                             moments=moments)
    assert np.isfinite(partial.final_loss)
    resumed = _fit_two_tower(str(tmp_path / "tt"), epochs=4, every=2,
                             moments=moments)
    _same_model(resumed, straight)
    assert resumed.final_loss == straight.final_loss


def test_two_tower_repeated_interruption_resumes_each_time(tmp_path):
    straight = _fit_two_tower(None, epochs=6, every=0)
    d = str(tmp_path / "tt")
    _fit_two_tower(d, epochs=2, every=1)
    _fit_two_tower(d, epochs=4, every=1)
    resumed = _fit_two_tower(d, epochs=6, every=1)
    _same_model(resumed, straight)
    assert TrainCheckpointer(d).all_steps() == [4, 5, 6]  # checkpoint_keep 3


def test_maybe_resume_logs_resume_epoch(tmp_path, caplog):
    d = str(tmp_path / "tt")
    _fit_two_tower(d, epochs=2, every=1)
    with caplog.at_level(
            logging.INFO, logger="incubator_predictionio_tpu_torch.utils.checkpoint"):
        _fit_two_tower(d, epochs=4, every=1)
    msgs = [r.getMessage() for r in caplog.records
            if "resuming from epoch" in r.getMessage()]
    assert msgs and "resuming from epoch 2" in msgs[0]


def test_two_tower_stale_checkpoint_restarts_fresh(tmp_path):
    """A checkpoint left by a *completed* run must not short-circuit the
    next run."""
    d = str(tmp_path / "tt")
    _fit_two_tower(d, epochs=2, every=2)          # completes, leaves step 2
    again = _fit_two_tower(d, epochs=2, every=2)  # stale → fresh retrain
    straight = _fit_two_tower(None, epochs=2, every=0)
    assert np.isfinite(again.final_loss)
    _same_model(again, straight)
    # the three fresh-start outcomes of maybe_resume
    p = [torch.zeros(2)]
    assert maybe_resume(None, 1, 3, p, None, 4)[0] is None
    assert maybe_resume(d, 0, 3, p, None, 4)[0] is None
    ck, _, _, start = maybe_resume(d, 1, 3, p, None, 2)  # latest 2 ≥ 2
    assert start == 0 and ck.all_steps() == []


def test_two_tower_shape_change_restarts_fresh(tmp_path):
    d = str(tmp_path / "tt")
    _fit_two_tower(d, epochs=2, every=2, n_users=40)
    grown = _fit_two_tower(d, epochs=4, every=2, n_users=56)
    assert grown.user_emb.shape[0] == 56
    assert np.isfinite(grown.final_loss)
    _same_model(grown, _fit_two_tower(None, epochs=4, every=0, n_users=56))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_resumed_two_tower_fit_is_in_the_jax_bands(tmp_path, monkeypatch, moments):
    """The port interrupted after 1 epoch and resumed to 3, from the
    reference's own initial tables, against the JAX package's
    uninterrupted 3-epoch fit, on test_torch_two_tower_training.py's
    triples (``_triples``: seed 11, 4,500 of 300 × 120)."""
    users, items, ratings, nu, ni = _data(n_users=300, n=4500, n_items=120,
                                          seed=11)
    cfg = dict(rank=8, epochs=3, batch_size=1024, seed=3, gather="host",
               adam_moments_dtype=moments)
    seen = {}
    real = jtt._train_epochs

    def capture(p, o, *a):
        seen.setdefault("init", {k: np.array(v) for k, v in p.items()})
        return real(p, o, *a)

    monkeypatch.setattr(jtt, "_train_epochs", capture)
    want = jtt.TwoTowerMF(jtt.TwoTowerConfig(**cfg)).fit(
        MeshContext.create(devices=__import__("jax").devices()[:1]),
        users, items, ratings, nu, ni)
    real = ttt._init_blocks

    def inject(c, ctx, a, b, gen):  # the whole tables: one block each
        placed = real(c, ctx, a, b, gen)
        for t, x in zip(placed, convert.two_tower_tables_from_jax(
                seen["init"], ctx.device)):
            t.array = x
        return placed

    monkeypatch.setattr(ttt, "_init_blocks", inject)
    d = str(tmp_path / "tt")
    ttt.TwoTowerMF(ttt.TwoTowerConfig(**dict(
        cfg, epochs=1, checkpoint_dir=d, checkpoint_every=1))).fit(
            CPU, users, items, ratings, nu, ni)
    got = ttt.TwoTowerMF(ttt.TwoTowerConfig(**dict(
        cfg, checkpoint_dir=d, checkpoint_every=1))).fit(
            CPU, users, items, ratings, nu, ni)
    assert TrainCheckpointer(d).latest_step() == 3
    np.testing.assert_allclose(got.final_loss, want.final_loss, rtol=LOSS_RTOL)
    for name in TABLES:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= TABLE_RTOL, name


def _fit_transformer(ckpt_dir, epochs, every):
    rng = np.random.default_rng(11)
    max_len, vocab, n = 8, 32, 64
    seqs = rng.integers(1, vocab, (n, max_len + 1)).astype(np.int32)
    cfg = ttr.TransformerConfig(vocab_size=vocab, max_len=max_len, d_model=16,
                                n_heads=2, n_layers=1, batch_size=32,
                                epochs=epochs, seed=5, attention="local",
                                checkpoint_dir=ckpt_dir, checkpoint_every=every)
    return ttr.TransformerRecommender(cfg).fit(CPU, seqs, item_map=None)


def test_transformer_resume_matches_uninterrupted(tmp_path):
    straight = _fit_transformer(None, epochs=4, every=0)
    _fit_transformer(str(tmp_path / "tf"), epochs=2, every=2)
    resumed = _fit_transformer(str(tmp_path / "tf"), epochs=4, every=2)
    assert np.isfinite(resumed.final_loss)
    assert resumed.final_loss == straight.final_loss
    assert resumed.step_losses.shape == (2, 2)  # the epochs this call ran
    _same_bits(resumed.step_losses, straight.step_losses[2:])

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    for a, b in zip(leaves(resumed.params), leaves(straight.params)):
        _same_bits(a, b)
