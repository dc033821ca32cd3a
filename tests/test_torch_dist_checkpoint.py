"""PyTorch port, checkpoints of a multi-process fit on the CPU:
``distributed/checkpoint.py:DistSliceCheckpointer``, the member-slice
filesystem protocol of ``utils/checkpoint.py`` and its plain
multi-process path, held against the JAX package's
(tests/test_distributed.py:233-456).

- Slice commits (fake members through ``slice_fn``): every member is
  required, the commit times out, a kill between slices restores the
  previous commit, a zombie cannot commit, a stale generation's slice
  never counts, retention gc, ``delete_all``, row blocks.
- Cross-reads, bitwise: a directory written by either package's
  ``save_member_slice`` / ``write_commit_marker`` (or whole
  checkpointers) reads the same through the other's
  ``assemble_committed_step``, bf16 leaves included (the reference
  writes them as two-byte void and cannot restore them; the port can).
- Fits: a two-tower fit that loses a member after the first commit
  resumes ("resuming from epoch 2") and ends bitwise equal to the
  uninterrupted fit; the degenerate ``DistContext`` fit is bitwise the
  plain fit; the resumed fit stays in the JAX fit's 3-epoch bands
  (tests/test_torch_two_tower_training.py: loss 1e-4 relative, tables
  1e-2 relative Frobenius).
- The plain multi-process path (threads as processes): the primary
  writes, every process restores the same step, a restore that fails on
  one process fails on all before any template is written.

Tolerances: bitwise wherever the same code runs on the same rows.
"""

import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_tpu.distributed.checkpoint import (  # noqa: E402
    DistSliceCheckpointer as JDistSliceCheckpointer,
)
from incubator_predictionio_tpu.parallel.mesh import MeshContext  # noqa: E402
from incubator_predictionio_tpu.utils import checkpoint as jck  # noqa: E402
from incubator_predictionio_tpu_torch.distributed import dist_metrics  # noqa: E402
from incubator_predictionio_tpu_torch.distributed.checkpoint import (  # noqa: E402
    DistSliceCheckpointer,
)
from incubator_predictionio_tpu_torch.distributed.context import (  # noqa: E402
    DistContext,
    maybe_wrap_distributed,
)
from incubator_predictionio_tpu_torch.distributed.errors import (  # noqa: E402
    FencedGenerationError,
    MemberLostError,
)
from incubator_predictionio_tpu_torch.distributed.meshdir import MeshDirectory  # noqa: E402
from incubator_predictionio_tpu_torch.models import two_tower as ttt  # noqa: E402
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext  # noqa: E402
from incubator_predictionio_tpu_torch.resilience.clock import FakeClock  # noqa: E402
from incubator_predictionio_tpu_torch.utils import checkpoint as ck  # noqa: E402
from incubator_predictionio_tpu_torch.utils import optim  # noqa: E402

from tests.test_torch_distributed_eval import Lockstep  # noqa: E402
from tests.test_torch_two_tower_training import _inject, _jax_fit  # noqa: E402

CPU = DeviceContext.create(device="cpu")
TABLES = ("user_emb", "item_emb", "user_bias", "item_bias")
LOSS_RTOL, TABLE_RTOL = 1e-4, 1e-2


def _same_bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), what


# -- slice commits (fake members through slice_fn) ----------------------------

def _half_rows(leaf_idx, leaf, member, members):
    """Fake two-member ownership: row-split leaves, 0-d leaves on 0."""
    a = np.asarray(leaf)
    if a.ndim == 0:
        return [(a, None)] if member == 0 else []
    rows = a.shape[0]
    per = rows // members
    lo, hi = member * per, (member + 1) * per if member < members - 1 else rows
    return [(a[lo:hi], [[lo, hi]] + [None] * (a.ndim - 1))]


def _member(tmp_path, member, md=None, generation=0, clock=None, keep=3):
    return DistSliceCheckpointer(
        str(tmp_path / "ck"), max_to_keep=keep, members=2, member=member,
        generation=generation, meshdir=md, slice_fn=_half_rows,
        clock=clock or FakeClock(), commit_timeout_ms=200)


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"t": torch.randn(8, 3, generator=g)},
            "epoch": ck.scalar(seed)}


def _like():
    return {"params": {"t": torch.zeros(8, 3)}, "epoch": ck.scalar(0)}


def test_slice_commit_requires_every_member(tmp_path):
    m0, m1 = _member(tmp_path, 0), _member(tmp_path, 1)
    state = _state(2)
    before = dist_metrics.DIST_COMMITS.value
    m1.save(2, state)  # member 0 is the committer: nothing restorable yet
    assert m1.latest_step() is None
    m0.save(2, state)
    assert m0.latest_step() == 2 and m1.all_steps() == [2]
    assert dist_metrics.DIST_COMMITS.value == before + 1
    like = _like()
    got = m1.restore(like=like)
    assert got["params"]["t"] is like["params"]["t"]  # copied into the template
    assert torch.equal(got["params"]["t"], state["params"]["t"])
    assert int(got["epoch"]) == 2


def test_commit_timeout_when_member_never_writes(tmp_path):
    m0 = _member(tmp_path, 0)
    before = dist_metrics.DIST_STEP_ABORTS.value
    with pytest.raises(MemberLostError, match=r"members \[1\]"):
        m0.save(1, _state(1))
    assert m0.latest_step() is None  # no half-committed step
    assert dist_metrics.DIST_STEP_ABORTS.value == before + 1


def test_kill_between_slices_restores_previous_commit(tmp_path):
    """A kill between two members' slice writes can never compose two
    histories: restore returns the previous complete commit."""
    m0, m1 = _member(tmp_path, 0), _member(tmp_path, 1)
    old = _state(10)
    m1.save(10, old)
    m0.save(10, old)
    with pytest.raises(MemberLostError):  # member 1 died before its slice
        m0.save(11, _state(11))
    assert m0.latest_step() == 10
    got = m0.restore(like=_like())
    assert torch.equal(got["params"]["t"], old["params"]["t"])
    with pytest.raises(FileNotFoundError, match="no commit marker"):
        ck.assemble_committed_step(str(tmp_path / "ck"), 11)


def test_zombie_generation_cannot_commit(tmp_path):
    clock = FakeClock()
    md = MeshDirectory(str(tmp_path / "mesh"), now_fn=clock.monotonic)
    md.announce_generation(1, 2)
    m0 = _member(tmp_path, 0, md=md, generation=1, clock=clock)
    m1 = _member(tmp_path, 1, md=md, generation=1, clock=clock)
    m1.save(1, _state(3))
    m0.save(1, _state(3))
    assert md.last_commit()["step"] == 1
    md.bump_generation(2)  # the mesh re-formed; the old committer returns
    before = dist_metrics.DIST_FENCED.value
    with pytest.raises(FencedGenerationError):
        m0.save(2, _state(4))
    assert dist_metrics.DIST_FENCED.value == before + 1
    assert m0.latest_step() == 1
    assert not os.path.exists(ck.slice_step_dir(str(tmp_path / "ck"), 2))


def test_stale_generation_slice_never_satisfies_new_commit(tmp_path):
    m0_new = _member(tmp_path, 0, generation=2)
    m1_new = _member(tmp_path, 1, generation=2)
    state = _state(5)
    # the old generation's member 1 wrote step 3, then its mesh died
    ck.save_member_slice(str(tmp_path / "ck"), 3, 1, 1, [
        {"key": "l0b0", "leaf": 0, "globalShape": [8, 3],
         "index": [[4, 8], None]}], {"l0b0": np.zeros((4, 3), np.float32)})
    assert ck.members_done(str(tmp_path / "ck"), 3, 2, 2) == []
    m1_new.save(3, state)
    m0_new.save(3, state)
    assert ck.read_commit_marker(str(tmp_path / "ck"), 3)["generation"] == 2
    got = m0_new.restore(like=_like())
    assert torch.equal(got["params"]["t"], state["params"]["t"])


def test_slice_retention_gc(tmp_path):
    m0, m1 = _member(tmp_path, 0, keep=2), _member(tmp_path, 1, keep=2)
    for step in (1, 2, 3):
        m1.save(step, _state(step))
        m0.save(step, _state(step))
    assert m0.all_steps() == [2, 3]
    assert ck.read_member_slice(str(tmp_path / "ck"), 1, 0) is None
    # an uncommitted step dir older than the newest commit goes too
    os.makedirs(ck.slice_step_dir(str(tmp_path / "ck"), 0))
    ck.gc_slice_steps(str(tmp_path / "ck"), 2)
    assert not os.path.exists(ck.slice_step_dir(str(tmp_path / "ck"), 0))


def test_delete_all_drops_commits(tmp_path):
    m0, m1 = _member(tmp_path, 0), _member(tmp_path, 1)
    m1.save(1, _state(1))
    m0.save(1, _state(1))
    m0.delete_all()
    assert m0.latest_step() is None and m1.all_steps() == []
    with pytest.raises(FileNotFoundError, match="no committed steps"):
        m0.restore()


def test_row_blocks_must_cover_every_row(tmp_path):
    """Row blocks through slice_fn assemble the whole leaf; a leaf whose
    blocks leave a gap refuses to assemble."""
    d = str(tmp_path / "ck")
    table = np.arange(24, dtype=np.float32).reshape(8, 3)
    for m, (lo, hi) in enumerate(((0, 4), (4, 8))):
        ck.save_member_slice(d, 1, m, 0, [
            {"key": "l0b0", "leaf": 0, "globalShape": [8, 3],
             "index": [[lo, hi], None]}], {"l0b0": table[lo:hi]})
    ck.write_commit_marker(d, 1, 0, 2)
    _same_bits(ck.assemble_committed_step(d, 1)[0], table)
    ck.save_member_slice(d, 2, 0, 0, [
        {"key": "l0b0", "leaf": 0, "globalShape": [8, 3],
         "index": [[0, 4], None]}], {"l0b0": table[:4]})
    ck.save_member_slice(d, 2, 1, 0, [], {})
    ck.write_commit_marker(d, 2, 0, 2)
    with pytest.raises(ValueError, match="only covered to row 4 of 8"):
        ck.assemble_committed_step(d, 2)


# -- cross-reads between the packages, bitwise --------------------------------

def _leaf_set():
    rng = np.random.default_rng(4)
    bf16 = np.asarray(rng.normal(size=(6, 5)), np.float32)
    bf16_bits = (bf16.view(np.uint32) >> 16).astype(np.uint16)  # truncated bf16
    return [np.asarray(7, np.int32), np.asarray(123, np.int64),
            bf16_bits.view("V2"),
            rng.normal(size=(10, 4)).astype(np.float32),
            rng.integers(0, 9, size=(3,)).astype(np.int64)]


def _write(fs, d, leaves, generation=2):
    """Two members: member 0 the first rows of every 2-d leaf and every
    other leaf whole, member 1 the remaining rows."""
    parts = [([], {}), ([], {})]
    for i, a in enumerate(leaves):
        if a.ndim == 2:
            cut = a.shape[0] // 2
            for m, (lo, hi) in enumerate(((0, cut), (cut, a.shape[0]))):
                parts[m][0].append({"key": f"l{i}b0", "leaf": i,
                                    "globalShape": list(a.shape),
                                    "index": [[lo, hi], None]})
                parts[m][1][f"l{i}b0"] = a[lo:hi]
        else:
            parts[0][0].append({"key": f"l{i}b0", "leaf": i,
                                "globalShape": list(a.shape), "index": None})
            parts[0][1][f"l{i}b0"] = a
    for m, (entries, arrays) in enumerate(parts):
        fs.save_member_slice(d, 4, m, generation, entries, arrays)
    fs.write_commit_marker(d, 4, generation, 2)


@pytest.mark.parametrize("writer,reader", [(ck, jck), (jck, ck)],
                         ids=["torch-writes", "jax-writes"])
def test_slice_directories_cross_read_bitwise(tmp_path, writer, reader):
    leaves = _leaf_set()
    d = str(tmp_path / "ck")
    _write(writer, d, leaves)
    assert reader.committed_steps(d) == [4]
    assert reader.members_done(d, 4, 2, 2) == [0, 1]
    got = reader.assemble_committed_step(d, 4)
    assert len(got) == len(leaves)
    for i, (a, b) in enumerate(zip(got, leaves)):
        _same_bits(a, b, f"leaf {i}")
    # and the same directory through the writer's own reader
    for a, b in zip(writer.assemble_committed_step(d, 4), got):
        _same_bits(a, b)


def test_files_written_by_each_package_are_the_same_bytes(tmp_path):
    leaves = _leaf_set()
    for name, fs in (("jax", jck), ("torch", ck)):
        _write(fs, str(tmp_path / name), leaves)
    for rel in ("step-4/member-0.json", "step-4/member-1.json",
                "step-4/member-0.npz", "step-4/member-1.npz"):
        a = (tmp_path / "jax" / "slices" / rel).read_bytes()
        b = (tmp_path / "torch" / "slices" / rel).read_bytes()
        if rel.endswith(".json"):
            assert a == b, rel
        else:  # zip member timestamps differ; the arrays' bytes do not
            za, zb = np.load(tmp_path / "jax" / "slices" / rel), np.load(
                tmp_path / "torch" / "slices" / rel)
            assert za.files == zb.files
            for k in za.files:
                _same_bits(za[k], zb[k], k)


def _two_tower_state(moments):
    g = torch.Generator().manual_seed(3)
    tables = [torch.randn(9, 5, generator=g), torch.randn(7, 5, generator=g)]
    state = optim.adam_tree_init(tables, moments)
    for _ in range(2):
        optim.adam_apply(tables, [torch.randn(t.shape, generator=g)
                                  for t in tables], state, 1e-2)
    return {"params": tables, "opt": state, "epoch": ck.scalar(2)}


def _two_tower_like(moments):
    tables = [torch.zeros(9, 5), torch.zeros(7, 5)]
    return {"params": tables, "opt": optim.adam_tree_init(tables, moments),
            "epoch": ck.scalar(0)}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_port_checkpointer_directory_reads_in_the_reference(tmp_path, moments):
    """The port's slice checkpoint of a two-tower state: the reference's
    assembler reads every leaf bitwise, in the documented order (epoch,
    adam's count, m, v, the tables); the port restores it bitwise into a
    template, moments in their dtype, the count exact."""
    state = _two_tower_state(moments)
    DistSliceCheckpointer(str(tmp_path)).save(2, state)
    leaves = jck.assemble_committed_step(str(tmp_path), 2)
    want = [ck.leaf_to_numpy(x) for x in ck.state_leaves(state)]
    assert [a.dtype.str for a in leaves][:2] == ["<i4", "<i8"]
    assert len(leaves) == len(want) == 8
    for i, (a, b) in enumerate(zip(leaves, want)):
        _same_bits(a, b, f"leaf {i}")
    assert int(leaves[1]) == 2  # adam's count
    like = _two_tower_like(moments)
    got = DistSliceCheckpointer(str(tmp_path)).restore(like=like)
    assert got["params"][0] is like["params"][0]
    assert got["opt"].count == 2 and got["opt"].scratch == []
    for a, b in zip(got["opt"].m + got["opt"].v + got["params"],
                    state["opt"].m + state["opt"].v + state["params"]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_reference_checkpointer_directory_restores_in_the_port(tmp_path):
    """The reference's DistSliceCheckpointer writes a state; the port's
    restores it into a template of the same leaves, bitwise."""
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    t = rng.normal(size=(6, 3)).astype(np.float32)
    m = rng.normal(size=(6, 3)).astype(np.float32)
    jstate = {"epoch": jck.scalar(3), "opt": {"m": jnp.asarray(m)},
              "params": {"t": jnp.asarray(t)}}
    JDistSliceCheckpointer(str(tmp_path)).save(3, jstate)
    like = {"epoch": ck.scalar(0), "opt": {"m": torch.zeros(6, 3)},
            "params": {"t": torch.zeros(6, 3)}}
    got = DistSliceCheckpointer(str(tmp_path)).restore(like=like)
    assert int(got["epoch"]) == 3
    _same_bits(got["params"]["t"].numpy(), t)
    _same_bits(got["opt"]["m"].numpy(), m)


def test_reference_cannot_restore_a_bf16_leaf_the_port_can(tmp_path):
    """Reference finding (ROADMAP.md Queue 3): numpy writes JAX's bfloat16
    as two-byte void, so the reference's restore brings a bf16 moment back
    as ``|V2`` and its placement raises; its ``maybe_resume`` then deletes
    the commits and restarts from epoch 0. The port reads the same bytes
    back into a bf16 tensor bitwise."""
    import jax.numpy as jnp

    vals = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32).reshape(4, 3),
                       dtype=jnp.bfloat16)
    jstate = {"m": vals, "epoch": jck.scalar(2)}
    jckpt = JDistSliceCheckpointer(str(tmp_path))
    jckpt.save(2, jstate)
    assert jckpt.restore(like=jstate)["m"].dtype == np.dtype("V2")
    with pytest.raises(TypeError, match="V2"):
        jck.restore_placed(jckpt, jstate, MeshContext.create().mesh)
    like = {"m": torch.zeros(4, 3, dtype=torch.bfloat16), "epoch": ck.scalar(0)}
    got = DistSliceCheckpointer(str(tmp_path)).restore(like=like)
    assert got["m"].dtype == torch.bfloat16
    _same_bits(got["m"].view(torch.int16).numpy(),
               np.asarray(vals).view(np.int16))


def test_place_leaves_checks_before_it_writes(tmp_path):
    like = {"a": torch.ones(2, 2), "b": torch.ones(3)}
    with pytest.raises(ValueError, match="leaf 1"):
        ck.place_leaves(like, [np.zeros((2, 2), np.float32),
                               np.zeros(4, np.float32)])
    assert torch.equal(like["a"], torch.ones(2, 2))  # untouched
    with pytest.raises(ValueError, match="3 leaves, the template 2"):
        ck.place_leaves(like, [np.zeros(1)] * 3)


# -- fits ---------------------------------------------------------------------

def _triples(n=600, n_users=40, n_items=30, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n).astype(np.int32),
            rng.integers(0, n_items, n).astype(np.int32),
            (1 + 4 * rng.random(n)).astype(np.float32), n_users, n_items)


def _cfg(directory=None, epochs=4, moments="float32"):
    return ttt.TwoTowerConfig(rank=8, batch_size=128, epochs=epochs, seed=1,
                              checkpoint_dir=directory,
                              checkpoint_every=1 if directory else 0,
                              adam_moments_dtype=moments, gather="host")


def _dist(tmp_path, tag):
    from incubator_predictionio_tpu_torch.distributed.context import DistConfig

    return DistContext(CPU, DistConfig(state_dir=str(tmp_path / tag)),
                       start_threads=False)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_two_tower_fit_resumes_after_a_lost_member_bitwise(
        tmp_path, monkeypatch, caplog, moments):
    """A member is lost in the third chunk, after the commits of epochs 1
    and 2: the re-run resumes from the last commit and ends bitwise equal
    to a fit that never crashed, both adams' moment dtypes."""
    data = _triples()
    straight = ttt.TwoTowerMF(_cfg(moments=moments)).fit(CPU, *data)
    d = str(tmp_path / "ck")
    real = ttt._train_epochs
    calls = {"n": 0}

    def dying(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:  # the third chunk: epochs 1 and 2 are committed
            raise MemberLostError("peer heartbeat expired: rank 1")
        return real(*a, **k)

    monkeypatch.setattr(ttt, "_train_epochs", dying)
    with pytest.raises(MemberLostError):
        ttt.TwoTowerMF(_cfg(d, moments=moments)).fit(_dist(tmp_path, "m1"), *data)
    assert ck.committed_steps(d) == [1, 2]
    monkeypatch.setattr(ttt, "_train_epochs", real)
    with caplog.at_level(logging.INFO):
        resumed = ttt.TwoTowerMF(_cfg(d, moments=moments)).fit(
            _dist(tmp_path, "m2"), *data)
    assert "resuming from epoch 2" in caplog.text
    for name in TABLES:
        _same_bits(getattr(resumed, name), getattr(straight, name), name)
    assert resumed.final_loss == straight.final_loss
    assert ck.committed_steps(d) == [2, 3, 4]


def test_degenerate_dist_wrap_matches_plain_run(tmp_path, monkeypatch):
    """maybe_wrap_distributed on one process: the same factory seam as
    the multi-process path, bitwise the unwrapped fit; the commit is
    mirrored into the coordination directory."""
    data = _triples(seed=2)
    plain = ttt.TwoTowerMF(_cfg(str(tmp_path / "plain"))).fit(CPU, *data)
    monkeypatch.setenv("PIO_DIST_STATE_DIR", str(tmp_path / "mesh"))
    ctx = maybe_wrap_distributed(CPU)
    assert isinstance(ctx, DistContext) and ctx.dist_hooks is ctx
    assert ctx.process_count == 1 and ctx.is_primary and ctx.device == CPU.device
    wrapped = ttt.TwoTowerMF(_cfg(str(tmp_path / "dist"))).fit(ctx, *data)
    for name in TABLES:
        _same_bits(getattr(wrapped, name), getattr(plain, name), name)
    md = MeshDirectory(str(tmp_path / "mesh"))
    assert md.last_commit()["step"] == 4 and md.read_generation() == (0, 1)
    assert ctx.checkpointer_factory(str(tmp_path / "dist")).latest_step() == 4
    assert sorted(os.listdir(tmp_path / "plain")) == [
        "step-2.pt", "step-3.pt", "step-4.pt"]
    ctx.stop()
    assert md.members() == []


def test_resumed_dist_fit_is_in_the_jax_bands(tmp_path, monkeypatch):
    """The port's fit, interrupted after epoch 1 and resumed from its slice
    checkpoint, against the JAX package's uninterrupted 3-epoch fit from
    the same initial tables."""
    users, items, ratings, n_users, n_items = _triples(seed=5)
    want, seen = _jax_fit(monkeypatch, dict(rank=8, batch_size=128, epochs=3,
                                            seed=1, gather="host"),
                          users, items, ratings, n_users, n_items)
    _inject(monkeypatch, seen["init"])
    d = str(tmp_path / "ck")
    ttt.TwoTowerMF(_cfg(d, epochs=1)).fit(_dist(tmp_path, "m1"), users, items,
                                          ratings, n_users, n_items)
    got = ttt.TwoTowerMF(_cfg(d, epochs=3)).fit(_dist(tmp_path, "m2"), users,
                                                items, ratings, n_users, n_items)
    np.testing.assert_allclose(got.final_loss, want.final_loss, rtol=LOSS_RTOL)
    for name in TABLES:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= TABLE_RTOL, name


# -- the plain multi-process path (threads as processes) ----------------------

def _toy_train(params, opt, n):
    for _ in range(int(n)):
        params[0].mul_(1.5).add_(1.0)
        opt["c"] += 1
    return params, opt, params[0].sum()


def test_plain_multi_process_checkpoints_primary_writes(tmp_path, caplog):
    """Under a 2-process context without dist hooks, the primary alone
    writes ``step-<n>.pt``; an interrupted run resumes on both processes
    from the primary's latest step and ends equal to an uninterrupted
    one."""
    d = str(tmp_path / "ck")
    group = Lockstep(2)

    def run(epochs):
        def body(ctx):
            params = [torch.arange(6, dtype=torch.float32).reshape(3, 2)]
            out = ck.checkpointed_epochs(d, 1, 3, epochs, params, {"c": 0},
                                         _toy_train, ctx=ctx)
            return out[0][0].clone(), out[1]["c"]
        return group.run(body)

    first = run(2)
    assert sorted(os.listdir(d)) == ["step-1.pt", "step-2.pt"]
    with caplog.at_level(logging.INFO):
        resumed = run(4)
    assert caplog.text.count("resuming from epoch 2") == 2
    straight = [torch.arange(6, dtype=torch.float32).reshape(3, 2)]
    _toy_train(straight, {"c": 0}, 4)
    for w, c in resumed:
        assert torch.equal(w, straight[0]) and c == 4
    assert first[0][1] == first[1][1] == 2
    assert sorted(os.listdir(d)) == ["step-2.pt", "step-3.pt", "step-4.pt"]


def test_plain_multi_process_restore_fails_on_every_process(tmp_path):
    """A step that fails to restore on one process (here: process 1's
    template has another shape) fails on both, before any template is
    written; maybe_resume then deletes the state on the primary and both
    start fresh."""
    d = str(tmp_path / "ck")
    ck.TrainCheckpointer(d).save(1, {"params": [torch.ones(2, 2)], "opt": {},
                                     "epoch": ck.scalar(1)})
    group = Lockstep(2)

    def body(ctx):
        params = [torch.zeros(2, 2) if ctx.process_index == 0 else torch.zeros(3)]
        ckpt, p, _, start = ck.maybe_resume(d, 1, 3, params, {}, 4, ctx=ctx)
        return start, p[0].sum().item(), ckpt.latest_step()

    assert group.run(body) == [(0, 0.0, None), (0, 0.0, None)]
    assert os.listdir(d) == []


def test_plain_checkpointer_surface_under_a_stub_group(tmp_path):
    """A context claiming two processes is checkpointed by its primary;
    a secondary's save writes nothing (MirrorContext: peers that hold the
    same rows)."""
    from tests.test_torch_distributed_train import MirrorContext

    primary = MirrorContext(torch.device("cpu"), 0, 2, "gloo")
    secondary = MirrorContext(torch.device("cpu"), 1, 2, "gloo")
    ck.TrainCheckpointer(str(tmp_path / "b"), ctx=secondary).save(
        1, {"x": torch.ones(1)})
    assert os.listdir(tmp_path / "b") == []
    c = ck.TrainCheckpointer(str(tmp_path / "a"), ctx=primary)
    c.save(1, {"x": torch.ones(1)})
    assert c.latest_step() == 1
    c.delete_all()
    assert c.latest_step() is None
