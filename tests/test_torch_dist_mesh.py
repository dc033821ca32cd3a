"""PyTorch port, the distributed tier's coordination on the CPU:
``distributed/meshdir.py``, the guarded collective and the chunk hook of
``distributed/context.py``, and the ``dist status`` verb, held against the
JAX package's (tests/test_distributed.py:54-230, :477-510).

- MeshDirectory both ways: each package writes, the other reads, on one
  directory; the same calls on the same virtual clock write byte-identical
  files; generations only move forward, staleness and fencing are
  distinct verdicts, the health snapshot's quorum.
- The guarded collective on a FakeClock (no wall sleeps): a member that
  dies in the collective, one that stalls (its lease expires), the hard
  deadline, a generation bump, a healthy pass and ``on_chunk``'s beat —
  each scenario run on both packages, with the same verdict.
- ``dist status``: the port's JSON snapshot equals the reference's on the
  same directory, and so do the exit codes (0, 1 degraded, 2 no dir).
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from incubator_predictionio_tpu.data import sharded as jsh  # noqa: E402
from incubator_predictionio_tpu.distributed import context as jctx  # noqa: E402
from incubator_predictionio_tpu.distributed import meshdir as jmd  # noqa: E402
from incubator_predictionio_tpu.resilience.clock import FakeClock as JFakeClock  # noqa: E402
from incubator_predictionio_tpu_torch.data import sharded as tsh  # noqa: E402
from incubator_predictionio_tpu_torch.distributed import context as tctx  # noqa: E402
from incubator_predictionio_tpu_torch.distributed import dist_metrics  # noqa: E402
from incubator_predictionio_tpu_torch.distributed import meshdir as tmd  # noqa: E402
from incubator_predictionio_tpu_torch.resilience.clock import FakeClock  # noqa: E402

from tests.fixtures.fake_dist import FaultyShardCtx  # noqa: E402


class ShardCtx(FaultyShardCtx):
    """The fixture's context with the data-axis surface the port's
    sharded reads call (its data axis is every process); the JAX
    package's calls take no axis."""

    @property
    def data_index(self):
        return self.process_index

    @property
    def data_size(self):
        return self.process_count

    def allgather_obj(self, obj, axis=None):
        assert axis in (None, "data"), axis
        return super().allgather_obj(obj)


PKG = {"jax": (jmd, jctx, jsh, JFakeClock), "torch": (tmd, tctx, tsh, FakeClock)}
BOTH_WAYS = [("torch", "jax"), ("jax", "torch")]


# -- MeshDirectory ------------------------------------------------------------

@pytest.mark.parametrize("first,second", BOTH_WAYS)
def test_meshdir_generation_is_monotonic_across_packages(tmp_path, first, second):
    a = PKG[first][0].MeshDirectory(str(tmp_path))
    b = PKG[second][0].MeshDirectory(str(tmp_path))
    assert a.read_generation() == b.read_generation() == (0, 0)
    assert a.bump_generation(3) == 1
    assert b.bump_generation(3) == 2
    # announce never regresses: a slow member re-announcing its old
    # generation must not un-fence the zombies
    a.announce_generation(1, 3)
    assert b.read_generation() == (2, 3)
    b.announce_generation(5, 2)
    assert a.read_generation() == (5, 2)


@pytest.mark.parametrize("first,second", BOTH_WAYS)
def test_meshdir_staleness_and_fencing_across_packages(tmp_path, first, second):
    clock = FakeClock()
    a = PKG[first][0].MeshDirectory(str(tmp_path), now_fn=clock.monotonic)
    b = PKG[second][0].MeshDirectory(str(tmp_path), now_fn=clock.monotonic)
    a.announce_generation(2, 2)
    a.heartbeat(0, 2)
    a.heartbeat(1, 1)  # a zombie from generation 1
    clock.advance(0.05)
    for md in (a, b):
        assert [m.rank for m in md.alive_members(100)] == [0]
        assert md.stale_members(100) == []
    clock.advance(1.0)
    # the zombie is neither alive nor stale: it is fenced
    for md in (a, b):
        assert [m.rank for m in md.stale_members(100)] == [0]
    records = [[(m.rank, m.pid, m.generation, m.beat_at, m.step)
                for m in md.members()] for md in (a, b)]
    assert len(records[0]) == 2 and records[0] == records[1]


@pytest.mark.parametrize("first,second", BOTH_WAYS)
def test_meshdir_health_snapshot_quorum_across_packages(tmp_path, first, second):
    clock = FakeClock()
    a = PKG[first][0].MeshDirectory(str(tmp_path), now_fn=clock.monotonic)
    b = PKG[second][0].MeshDirectory(str(tmp_path), now_fn=clock.monotonic)
    a.announce_generation(1, 3)
    for r in range(3):
        a.heartbeat(r, 1)
    snaps = [md.health_snapshot(100) for md in (a, b)]
    assert snaps[0] == snaps[1]
    assert (snaps[0]["aliveMembers"], snaps[0]["quorum"],
            snaps[0]["degraded"]) == (3, 2, False)
    clock.advance(0.2)  # every lease expires
    b.heartbeat(2, 1)  # one member comes back
    snaps = [md.health_snapshot(100) for md in (a, b)]
    assert snaps[0] == snaps[1]
    assert snaps[0]["aliveMembers"] == 1 and snaps[0]["degraded"] is True
    b.record_commit(4, 1)
    assert a.health_snapshot(100)["lastCommit"]["step"] == 4


def test_meshdir_files_are_the_references_byte_for_byte(tmp_path):
    """The same calls at the same virtual times write the same bytes."""
    for name, pkg in (("jax", jmd), ("torch", tmd)):
        clock = FakeClock(1_700_000_000.0)
        md = pkg.MeshDirectory(str(tmp_path / name), now_fn=clock.monotonic)
        md.bump_generation(2)
        md.announce_generation(3, 2)
        clock.advance(0.5)
        md.heartbeat(0, 3, pid=111, step=4)
        md.heartbeat(1, 3, pid=222, step=4)
        md.record_commit(4, 3)
    names = sorted(n for n in os.listdir(tmp_path / "jax") if n.endswith(".json"))
    assert names == ["generation.json", "last-commit.json", "member-0.json",
                     "member-1.json"]
    assert sorted(n for n in os.listdir(tmp_path / "torch")
                  if n.endswith(".json")) == names
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "torch" / n).read_bytes(), n


def test_clear_members_drops_every_lease(tmp_path):
    md = tmd.MeshDirectory(str(tmp_path))
    md.heartbeat(0, 1)
    md.heartbeat(1, 1)
    md.clear_members()
    assert md.members() == []
    assert tmd.default_quorum(2) == 2 and tmd.default_quorum(5) == 3


# -- the guarded collective on a FakeClock ------------------------------------

def _dist_ctx(pkg, tmp_path, inner, clock, heartbeat_ms=100, generation=0,
              commit_timeout_ms=60_000, now_fn=None):
    md_mod, ctx_mod = PKG[pkg][0], PKG[pkg][1]
    md = md_mod.MeshDirectory(str(tmp_path), now_fn=now_fn or clock.monotonic)
    conf = ctx_mod.DistConfig(state_dir=str(tmp_path), heartbeat_ms=heartbeat_ms,
                              generation=generation,
                              commit_timeout_ms=commit_timeout_ms)
    return ctx_mod.DistContext(inner, conf, meshdir=md, clock=clock,
                               start_threads=False), md


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_member_dies_inside_concat_vocab_aborts_step(tmp_path, pkg):
    clock = PKG[pkg][3]()
    inner = ShardCtx([["u0"], ["u1"]], 0, die_in_collective=True)
    ctx, _md = _dist_ctx(pkg, tmp_path, inner, clock)
    before = dist_metrics.DIST_STEP_ABORTS.value
    with pytest.raises(PKG[pkg][1].MemberLostError, match="collective allgather_obj"):
        PKG[pkg][2].concat_vocab(ctx, ["u0"])
    if pkg == "torch":
        assert dist_metrics.DIST_STEP_ABORTS.value == before + 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_member_stalls_inside_global_sum_detected_via_lease(tmp_path, pkg):
    """The stalled collective never returns; the guard sees the silent
    peer's lease expire on VIRTUAL time and aborts."""
    clock = PKG[pkg][3]()
    inner = ShardCtx([3, 4], 0, stall_in_collective=True)
    ctx, md = _dist_ctx(pkg, tmp_path, inner, clock, heartbeat_ms=100)
    md.heartbeat(1, 0)  # the peer beat once, then went silent
    try:
        with pytest.raises(PKG[pkg][1].MemberLostError, match="rank 1"):
            PKG[pkg][2].global_sum(ctx, 3)
    finally:
        inner.release.set()
    assert clock.slept, "detection must ride the injected clock"


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_stalled_collective_hits_hard_deadline(tmp_path, pkg):
    """Peers look alive (frozen mesh time) but the collective never
    completes: the hard deadline aborts the step."""
    clock = PKG[pkg][3]()
    inner = ShardCtx([1, 2], 0, stall_in_collective=True)
    ctx, md = _dist_ctx(pkg, tmp_path, inner, clock, heartbeat_ms=20,
                        commit_timeout_ms=100, now_fn=lambda: 0.0)
    md.heartbeat(1, 0)
    try:
        with pytest.raises(PKG[pkg][1].MemberLostError, match="stalled past"):
            ctx.allgather_obj(1)
    finally:
        inner.release.set()
    # the deadline is max(10 heartbeats, the commit timeout): 0.2 s virtual
    assert 0.2 <= clock.monotonic() < 0.3


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_generation_bump_fences_collective_and_on_chunk(tmp_path, pkg):
    clock = PKG[pkg][3]()
    inner = ShardCtx([["a"], ["b"]], 0, stall_in_collective=True)
    ctx, md = _dist_ctx(pkg, tmp_path, inner, clock)
    md.heartbeat(1, 0)
    md.bump_generation(2)  # the supervisor re-formed the mesh without us
    before = dist_metrics.DIST_FENCED.value
    try:
        with pytest.raises(PKG[pkg][1].FencedGenerationError):
            ctx.allgather_obj(["a"])
    finally:
        inner.release.set()
    with pytest.raises(PKG[pkg][1].FencedGenerationError):
        ctx.on_chunk(5)
    if pkg == "torch":
        assert dist_metrics.DIST_FENCED.value >= before + 2


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_healthy_guarded_collective_passes_through(tmp_path, pkg):
    clock = PKG[pkg][3]()
    inner = ShardCtx([["u0"], ["u1"]], 0)
    ctx, md = _dist_ctx(pkg, tmp_path, inner, clock, heartbeat_ms=10_000_000)
    md.heartbeat(1, 0)
    vocab, offset = PKG[pkg][2].concat_vocab(ctx, ["u0"])
    assert list(vocab) == ["u0", "u1"] and offset == 0
    assert inner.calls == 1
    assert ctx.process_count == 2 and ctx.is_primary  # delegation


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_on_chunk_heartbeats_with_progress(tmp_path, pkg):
    clock = PKG[pkg][3]()
    inner = ShardCtx([[1], [2]], 0)
    ctx, md = _dist_ctx(pkg, tmp_path, inner, clock)
    md.heartbeat(1, 0)
    ctx.on_chunk(7)
    mine = [m for m in md.members() if m.rank == 0]
    assert mine and mine[0].step == 7
    if pkg == "torch":
        assert dist_metrics.DIST_MEMBERS.value == 2


def test_stop_drops_the_lease_and_leaves_the_group(tmp_path):
    """A member that finished is not a lost peer: ``stop`` leaves the
    group, then drops its lease (the heartbeat and watchdog threads run
    only in real multi-process mode)."""
    clock = FakeClock()
    inner = ShardCtx([[1], [2]], 1)
    stopped = []
    inner.stop = lambda: stopped.append(True)
    ctx, md = _dist_ctx("torch", tmp_path, inner, clock)
    md.heartbeat(0, 0)
    assert sorted(m.rank for m in md.members()) == [0, 1]
    ctx.stop()
    assert stopped == [True]
    assert [m.rank for m in md.members()] == [0]


def test_config_from_env(monkeypatch):
    for k, v in {"PIO_DIST_STATE_DIR": "/x", "PIO_DIST_HEARTBEAT_MS": "500",
                 "PIO_DIST_QUORUM": "2", "PIO_DIST_COMMIT_TIMEOUT_MS": "900",
                 "PIO_DIST_GENERATION": "4", "PIO_DIST_MAX_RECOVERIES": "1"}.items():
        monkeypatch.setenv(k, v)
    assert tctx.DistConfig.from_env() == tctx.DistConfig(
        "/x", 500, 2, 900, 4, 1)
    assert dataclass_fields(tctx.DistConfig) == dataclass_fields(jctx.DistConfig)
    assert (tctx.ABORT_RC, tctx.FENCED_RC) == (jctx.ABORT_RC, jctx.FENCED_RC) == (86, 87)


def dataclass_fields(cls):
    import dataclasses

    return [(f.name, f.default) for f in dataclasses.fields(cls)]


# -- dist status against the reference's cmd_dist_status --------------------

def _status(pkg, argv, capsys):
    if pkg == "jax":
        from incubator_predictionio_tpu.tools import cli
    else:
        from incubator_predictionio_tpu_torch.tools import cli
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


def _no_age(snap):
    return {**snap, "members": [{k: v for k, v in m.items() if k != "ageMs"}
                                for m in snap["members"]]}


def test_dist_status_is_the_references(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("PIO_DIST_STATE_DIR", raising=False)
    monkeypatch.delenv("PIO_DIST_QUORUM", raising=False)
    monkeypatch.delenv("PIO_DIST_HEARTBEAT_MS", raising=False)
    healthy = tmp_path / "healthy"
    md = tmd.MeshDirectory(str(healthy))  # wall clock: the beats are fresh
    md.announce_generation(1, 2)
    md.heartbeat(0, 1, pid=111, step=4)
    md.heartbeat(1, 1, pid=222, step=4)
    md.record_commit(4, 1)
    # beats at virtual t=0 are decades stale against the CLI's wall clock
    stale = tmp_path / "stale"
    clock = FakeClock()
    md = jmd.MeshDirectory(str(stale), now_fn=clock.monotonic)
    md.announce_generation(1, 2)
    md.heartbeat(0, 1)
    md.heartbeat(1, 1)
    for state_dir, want_rc in ((healthy, 0), (stale, 1)):
        argv = ["dist", "status", "--state-dir", str(state_dir)]
        got = {pkg: _status(pkg, argv + ["--json"], capsys) for pkg in PKG}
        assert got["jax"][0] == got["torch"][0] == want_rc
        snaps = {pkg: json.loads(out) for pkg, (_, out) in got.items()}
        assert _no_age(snaps["jax"]) == _no_age(snaps["torch"])
        text = {pkg: _status(pkg, argv, capsys) for pkg in PKG}
        assert text["jax"][0] == text["torch"][0] == want_rc
        lines = {pkg: [ln for ln in out.splitlines() if "beat" not in ln]
                 for pkg, (_, out) in text.items()}
        assert lines["jax"] == lines["torch"]
    assert "DEGRADED" in text["torch"][1] and "STALE" in text["torch"][1]
    assert "generation: 1" in text["torch"][1] and "2/2" not in text["torch"][1]
    # no directory anywhere: a usage error, distinct from "degraded"
    for pkg in PKG:
        assert _status(pkg, ["dist", "status"], capsys)[0] == 2
    from incubator_predictionio_tpu_torch.tools import cli

    assert cli.main(["dist"]) == 1


WATCHDOG_CHILD = r"""
import sys, time
from incubator_predictionio_tpu_torch.distributed import context as tctx
from incubator_predictionio_tpu_torch.distributed import meshdir as tmd

class Inner:
    process_index, process_count = 0, 2
    def stop(self):
        pass

state, case = sys.argv[1], sys.argv[2]
md = tmd.MeshDirectory(state)
md.announce_generation(1, 2)
md.heartbeat(1, 1)  # the peer beat once, then went silent
ctx = tctx.DistContext(Inner(), tctx.DistConfig(state_dir=state,
                                                heartbeat_ms=200,
                                                generation=1), meshdir=md)
if case != "in-step":
    ctx.collectives_done()
if case == "fenced":
    md.bump_generation(2)
time.sleep(1.5)
ctx.stop()
print("gap", ctx.beat_gap_max_s)
"""


@pytest.mark.parametrize("case,rc", [("in-step", tctx.ABORT_RC),
                                     ("done", 0), ("fenced", tctx.FENCED_RC)])
def test_watchdog_after_the_last_collective(tmp_path, case, rc):
    """The real watchdog thread (wall clock, its own process): a silent
    peer aborts the member while it may still be in a collective, not
    once ``collectives_done`` said none follows; a generation bump still
    fences it then."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", WATCHDOG_CHILD, str(tmp_path), case],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == rc, out.stderr[-2000:]
    if rc == 0:
        gap = float(out.stdout.split("gap")[-1])
        assert 0.0 < gap < 1.5, out.stdout
        assert [m.rank for m in tmd.MeshDirectory(str(tmp_path)).members()] == [1]
