"""MeshDirectory — the durable coordination directory of a distributed run.

Counterpart of ``incubator_predictionio_tpu/distributed/meshdir.py``
(:class:`MemberRecord`, :func:`default_quorum`, :class:`MeshDirectory`).
The members and their supervisor share no sockets beyond the collectives
themselves, which cannot carry control decisions (a hung all-gather is
exactly the failure being detected). Coordination instead rides a
directory of small atomically written JSON records (``utils/fs.
atomic_write_bytes``), so every decision survives a kill and reads with
``cat`` (and ``dist status``):

- ``generation.json``: the monotonic mesh **generation**, the fencing
  token, bumped by the supervisor every time the mesh re-forms. A member
  that reads a generation newer than its own is a zombie from a torn-down
  mesh: it must neither commit a checkpoint nor answer a collective.
- ``member-<rank>.json``: a member's heartbeat lease: pid, generation,
  last beat (wall clock: monotonic clocks do not compare across
  processes) and the member's last reported step.
- ``last-commit.json``: the newest coordinated checkpoint commit, for
  ``dist status`` (the authoritative markers live in the checkpoint
  directory; this is the observability mirror).
- ``.lock``: the flock that serialises read-modify-writes of the
  generation.

The files are the reference's, key for key (JSON with sorted keys), so
either package's :class:`MeshDirectory` reads the other's directory. The
time source is injectable (``now_fn``), so staleness decisions are
testable on a virtual clock. Writes of one record from one instance are
serialised (a member's heartbeat thread and its chunk-boundary beat share
the record's temporary file); writes of different records are not, so a
lease renewal never waits behind the commit record's fsync.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from incubator_predictionio_tpu_torch.utils.fs import atomic_write_bytes

GENERATION_FILE = "generation.json"
LAST_COMMIT_FILE = "last-commit.json"
LOCK_FILE = ".lock"


@dataclass(frozen=True)
class MemberRecord:
    """One member's heartbeat lease as last written."""

    rank: int
    pid: int
    generation: int
    beat_at: float
    step: int

    def age_s(self, now: float) -> float:
        return max(0.0, now - self.beat_at)


def default_quorum(members: int) -> int:
    """Majority: the smallest count that cannot split-brain."""
    return members // 2 + 1


class MeshDirectory:
    """Read and write the coordination records under ``state_dir``."""

    def __init__(self, state_dir: str, now_fn: Callable[[], float] = time.time):
        self.state_dir = os.path.abspath(state_dir)
        os.makedirs(self.state_dir, exist_ok=True)
        self._now = now_fn
        # one lock a file: a lease renewal never waits behind another
        # record's fsync
        self._write_locks: dict[str, threading.Lock] = {}
        self._locks_guard = threading.Lock()

    def now(self) -> float:
        """The clock the leases are written and aged on."""
        return self._now()

    # -- generation (the fencing token) -----------------------------------
    def read_generation(self) -> tuple[int, int]:
        """``(generation, members)``; ``(0, 0)`` before the first announce."""
        rec = self._read_json(GENERATION_FILE)
        if not rec:
            return 0, 0
        return int(rec.get("generation", 0)), int(rec.get("members", 0))

    def announce_generation(self, generation: int, members: int) -> None:
        """Persist a generation the caller already owns (a member's
        bootstrap from ``PIO_DIST_GENERATION``): idempotent, never moves
        backwards."""
        with self._locked():
            current, _ = self.read_generation()
            if generation < current:
                return
            self._write_json(GENERATION_FILE, {
                "generation": int(generation), "members": int(members),
                "updatedAt": self._now(),
            })

    def bump_generation(self, members: int) -> int:
        """Advance the fencing token (the supervisor, before re-forming the
        mesh). Durable before it returns: a zombie that reads the directory
        after this sees itself fenced."""
        with self._locked():
            current, _ = self.read_generation()
            nxt = current + 1
            self._write_json(GENERATION_FILE, {
                "generation": nxt, "members": int(members),
                "updatedAt": self._now(),
            })
            return nxt

    # -- heartbeats --------------------------------------------------------
    def heartbeat(self, rank: int, generation: int, pid: Optional[int] = None,
                  step: int = 0) -> None:
        """Renew member ``rank``'s lease. Not fsynced: a lost heartbeat is
        indistinguishable from a late one and the next beat overwrites it."""
        self._write_json(f"member-{int(rank)}.json", {
            "rank": int(rank),
            "pid": int(os.getpid() if pid is None else pid),
            "generation": int(generation),
            "beatAt": self._now(),
            "step": int(step),
        }, durable=False)

    def members(self) -> list[MemberRecord]:
        out = []
        for name in sorted(os.listdir(self.state_dir)):
            if not (name.startswith("member-") and name.endswith(".json")):
                continue
            rec = self._read_json(name)
            if not rec:
                continue
            out.append(MemberRecord(
                rank=int(rec.get("rank", -1)),
                pid=int(rec.get("pid", 0)),
                generation=int(rec.get("generation", 0)),
                beat_at=float(rec.get("beatAt", 0.0)),
                step=int(rec.get("step", 0)),
            ))
        return out

    def stale_members(self, heartbeat_ms: int,
                      generation: Optional[int] = None) -> list[MemberRecord]:
        """Members of ``generation`` (default: the current one) whose lease
        expired. Records of older generations are not stale: they are
        *fenced*, another verdict (the member is not lost, its mesh is
        gone)."""
        gen = self.read_generation()[0] if generation is None else generation
        now = self._now()
        return [m for m in self.members()
                if m.generation == gen and m.age_s(now) * 1000.0 > heartbeat_ms]

    def alive_members(self, heartbeat_ms: int,
                      generation: Optional[int] = None) -> list[MemberRecord]:
        gen = self.read_generation()[0] if generation is None else generation
        now = self._now()
        return [m for m in self.members()
                if m.generation == gen and m.age_s(now) * 1000.0 <= heartbeat_ms]

    def clear_members(self) -> None:
        """Drop every heartbeat record (the supervisor, between
        generations: a dead member's last beat must not read as alive in
        the new one)."""
        for name in os.listdir(self.state_dir):
            if name.startswith("member-") and name.endswith(".json"):
                with contextlib.suppress(OSError):
                    os.unlink(os.path.join(self.state_dir, name))

    # -- commit mirror -----------------------------------------------------
    def record_commit(self, step: int, generation: int) -> None:
        self._write_json(LAST_COMMIT_FILE, {
            "step": int(step), "generation": int(generation),
            "committedAt": self._now(),
        })

    def last_commit(self) -> Optional[dict]:
        return self._read_json(LAST_COMMIT_FILE) or None

    # -- health ------------------------------------------------------------
    def health_snapshot(self, heartbeat_ms: int,
                        quorum: Optional[int] = None) -> dict:
        """The ``dist status`` payload: generation, expected and alive
        members, last commit, the quorum verdict."""
        generation, expected = self.read_generation()
        now = self._now()
        members = [{
            "rank": m.rank, "pid": m.pid, "generation": m.generation,
            "ageMs": round(m.age_s(now) * 1000.0, 1), "step": m.step,
            "alive": m.generation == generation
                     and m.age_s(now) * 1000.0 <= heartbeat_ms,
        } for m in self.members()]
        alive = sum(1 for m in members if m["alive"])
        need = default_quorum(expected) if quorum is None else quorum
        return {
            "stateDir": self.state_dir,
            "generation": generation,
            "expectedMembers": expected,
            "aliveMembers": alive,
            "quorum": need,
            "degraded": expected > 0 and alive < need,
            "members": members,
            "lastCommit": self.last_commit(),
        }

    # -- plumbing ----------------------------------------------------------
    def _path(self, name: str) -> str:
        return os.path.join(self.state_dir, name)

    def _read_json(self, name: str) -> dict:
        try:
            with open(self._path(name), "rb") as f:
                return json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError):
            # an atomic write is never torn: a missing file (no beat yet)
            # and an unparsable one (foreign junk) both read as absent
            return {}

    def _write_json(self, name: str, payload: dict, durable: bool = True) -> None:
        with self._locks_guard:
            lock = self._write_locks.setdefault(name, threading.Lock())
        with lock:
            atomic_write_bytes(self._path(name),
                               json.dumps(payload, sort_keys=True).encode("utf-8"),
                               durable=durable)

    @contextlib.contextmanager
    def _locked(self):
        """flock-guarded read-modify-write of the generation record: the
        supervisor and a bootstrapping member may race an announce."""
        import fcntl

        fd = os.open(self._path(LOCK_FILE), os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)
