"""DistContext — the fault-aware wrapper a supervised member trains under.

Counterpart of ``incubator_predictionio_tpu/distributed/context.py``:
:class:`DistConfig` (the reference's ``PIO_DIST_*`` variables),
:func:`maybe_wrap_distributed` (the workflow's seam), :data:`ABORT_RC` /
:data:`FENCED_RC` and :class:`DistContext`, which duck-types
``parallel/mesh.py:DeviceContext`` (every attribute it does not define
delegates to the wrapped context, so engine and stage code is unchanged)
and adds the member side of the fault-tolerant tier:

- **heartbeat lease**: a daemon thread renews ``member-<rank>.json`` in
  the :class:`~incubator_predictionio_tpu_torch.distributed.meshdir.
  MeshDirectory` every third of ``PIO_DIST_HEARTBEAT_MS``;
- **collective guard**: the host-level collective (``allgather_obj``,
  which the sharded reads, the checkpoints' barriers and the replica
  check ride) runs in a side thread while the caller polls the peers'
  leases and the fence: a peer whose lease expires, a generation bump or
  a failed collective aborts the step with :class:`MemberLostError` /
  :class:`FencedGenerationError` instead of hanging;
- **self-abort**: the in-step ``all_gather`` / ``all_reduce`` of a fit,
  over gloo or NCCL, cannot be cancelled from Python, so in real
  multi-process mode a watchdog thread ``os._exit``\\ s the process when a
  peer is lost or the member is fenced; the supervisor sees the exit and
  re-forms the mesh. One step lost, never a hang;
- the fit seams: ``dist_hooks``, :meth:`DistContext.checkpointer_factory`
  (member-slice checkpoints) and :meth:`DistContext.on_chunk` (a beat
  with progress and a peer check at each chunk boundary).

:meth:`DistContext.collectives_done` (called by ``run_train`` once
``engine.train`` returns) ends the member-lost verdict of the watchdog:
past its last collective a member has nothing a lost peer could block,
so a peer that finished too and whose lease ages while it leaves does not
abort the primary's persistence; the fence check stays until
:meth:`DistContext.stop`. ``stop`` ends the watchdog, leaves the process
group while the lease is still renewed, then drops the member's lease (the
reference's watchdog would read a finished member's lease as expired). The single-process mesh gets
the same wrapper minus the threads, so every fencing and checkpoint
contract runs in tier-1 tests on a FakeClock with no wall sleeps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
from typing import Any, Optional

from incubator_predictionio_tpu_torch.distributed import dist_metrics
from incubator_predictionio_tpu_torch.distributed.checkpoint import DistSliceCheckpointer
from incubator_predictionio_tpu_torch.distributed.errors import (
    FencedGenerationError,
    MemberLostError,
)
from incubator_predictionio_tpu_torch.distributed.meshdir import MeshDirectory
from incubator_predictionio_tpu_torch.resilience.clock import SYSTEM_CLOCK, Clock

logger = logging.getLogger(__name__)

#: exit codes a self-aborting member hands the supervisor, distinct from a
#: Python crash's 1
ABORT_RC = 86    # lost a peer mid-step
FENCED_RC = 87   # fenced by a newer generation

#: collective-guard poll cadence (wall under SystemClock, virtual under Fake)
_POLL_S = 0.05


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """The reference's ``PIO_DIST_*`` surface (its context.py:56-76)."""

    state_dir: str = ""
    heartbeat_ms: int = 2000
    quorum: int = 0            # 0 = majority of expected members
    commit_timeout_ms: int = 60_000
    generation: int = 0
    max_recoveries: int = 2

    @staticmethod
    def from_env() -> "DistConfig":
        return DistConfig(
            state_dir=os.environ.get("PIO_DIST_STATE_DIR", ""),
            heartbeat_ms=int(os.environ.get("PIO_DIST_HEARTBEAT_MS", "2000")),
            quorum=int(os.environ.get("PIO_DIST_QUORUM", "0")),
            commit_timeout_ms=int(
                os.environ.get("PIO_DIST_COMMIT_TIMEOUT_MS", "60000")),
            generation=int(os.environ.get("PIO_DIST_GENERATION", "0")),
            max_recoveries=int(os.environ.get("PIO_DIST_MAX_RECOVERIES", "2")),
        )


def maybe_wrap_distributed(ctx, clock: Clock = SYSTEM_CLOCK):
    """The workflow seam: wrap ``ctx`` when ``PIO_DIST_STATE_DIR`` names a
    coordination directory (the supervisor sets it for its members),
    return it untouched otherwise."""
    conf = DistConfig.from_env()
    if not conf.state_dir:
        return ctx
    return DistContext(ctx, conf, clock=clock)


class DistContext:
    """One member's fault-aware view of the mesh."""

    def __init__(
        self,
        inner,
        conf: DistConfig,
        meshdir: Optional[MeshDirectory] = None,
        clock: Clock = SYSTEM_CLOCK,
        start_threads: Optional[bool] = None,
    ):
        self._inner = inner
        self.conf = conf
        self._clock = clock
        self.generation = conf.generation
        self.meshdir = meshdir or (
            MeshDirectory(conf.state_dir) if conf.state_dir else None)
        self._step = 0
        #: the longest wait between two of this member's lease renewals
        #: (real multi-process mode; logged at :meth:`stop`)
        self.beat_gap_max_s = 0.0
        self._stop = threading.Event()
        self._stop_watch = threading.Event()
        self._collectives_done = threading.Event()
        self._threads: list[threading.Thread] = []
        if self.meshdir is not None:
            self.meshdir.announce_generation(self.generation,
                                             inner.process_count)
            self.meshdir.heartbeat(inner.process_index, self.generation,
                                   step=0)
        dist_metrics.DIST_GENERATION.set(self.generation)
        real = (inner.process_count > 1 and self.meshdir is not None
                if start_threads is None else start_threads)
        if real:
            self._start_threads()

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    # -- the fit() seam ----------------------------------------------------
    @property
    def dist_hooks(self) -> "DistContext":
        """What trainers pick up through ``getattr(ctx, "dist_hooks",
        None)``."""
        return self

    def checkpointer_factory(self, directory: str, max_to_keep: int = 3,
                             layout=None) -> DistSliceCheckpointer:
        """``maybe_resume(factory=...)``: slice checkpoints instead of the
        whole-state file (of a model-axis fit's row blocks with its
        ``utils/checkpoint.py:RowBlocks`` ``layout``)."""
        return DistSliceCheckpointer(
            directory,
            max_to_keep=max_to_keep,
            members=self._inner.process_count,
            member=self._inner.process_index,
            generation=self.generation,
            meshdir=self.meshdir,
            clock=self._clock,
            commit_timeout_ms=self.conf.commit_timeout_ms,
            layout=layout,
        )

    def on_chunk(self, epoch: int) -> None:
        """Chunk-boundary hook of ``checkpointed_epochs``: renew the lease
        with training progress, then verify the mesh is still ours:
        aborting here costs one chunk, hanging in the next collective the
        whole heartbeat timeout."""
        self._step = int(epoch)
        if self.meshdir is not None:
            self.meshdir.heartbeat(self._inner.process_index, self.generation,
                                   step=self._step)
        self.check_peers()

    def collectives_done(self) -> None:
        """This member has run its last collective (module docstring):
        from now on the watchdog exits for a fence only."""
        self._collectives_done.set()

    # -- fault detection ---------------------------------------------------
    def check_peers(self) -> None:
        """Raise the verdict for the mesh's state: fenced when the
        generation moved past ours, member-lost when a peer's lease
        expired; otherwise update the liveness gauge."""
        if self.meshdir is None:
            return
        current, _ = self.meshdir.read_generation()
        if current > self.generation:
            dist_metrics.DIST_FENCED.inc()
            raise FencedGenerationError(
                f"mesh generation is {current}, this member holds "
                f"{self.generation}")
        stale = self.meshdir.stale_members(self.conf.heartbeat_ms,
                                           self.generation)
        if stale:
            dist_metrics.DIST_STEP_ABORTS.inc()
            now = self.meshdir.now()
            raise MemberLostError(
                "peer heartbeat expired: "
                + ", ".join(f"rank {m.rank} (pid {m.pid}, last beat "
                            f"{m.age_s(now):.2f} s ago)" for m in stale))
        dist_metrics.DIST_MEMBERS.set(
            len(self.meshdir.alive_members(self.conf.heartbeat_ms,
                                           self.generation)))

    def allgather_obj(self, obj: Any, axis: Optional[str] = None) -> list[Any]:
        """The guarded host-object collective (along ``axis`` when one is
        named). Without a coordination directory, a straight delegate."""
        def call():
            return self._inner.allgather_obj(obj, axis=axis)

        if self.meshdir is None:
            return call()
        return self._guarded("allgather_obj", call)

    def _guarded(self, what: str, fn):
        """Run a blocking collective in a side thread and poll for loss:
        the collective has no cancellable handle, so the guard turns 'a
        peer died, the call will never return' into a prompt
        MemberLostError (the stuck daemon thread is abandoned: the process
        is about to abort the step or exit)."""
        box: dict[str, Any] = {}
        done = threading.Event()

        def run():
            try:
                box["value"] = fn()
            except BaseException as e:  # noqa: BLE001 — relayed as verdict
                box["error"] = e
            finally:
                done.set()

        threading.Thread(target=run, daemon=True,
                         name=f"dist-{what}").start()
        hb_s = self.conf.heartbeat_ms / 1000.0
        deadline = self._clock.monotonic() + max(
            10.0 * hb_s, self.conf.commit_timeout_ms / 1000.0)
        while not done.is_set():
            self.check_peers()
            if self._clock.monotonic() >= deadline:
                dist_metrics.DIST_STEP_ABORTS.inc()
                raise MemberLostError(
                    f"collective {what} stalled past the loss deadline")
            self._clock.sleep(min(hb_s / 4.0, _POLL_S))
            # scheduling yield: under a FakeClock the sleep above is
            # virtual, so give the collective thread a real slot to finish
            done.wait(0.001)
        if "error" in box:
            dist_metrics.DIST_STEP_ABORTS.inc()
            raise MemberLostError(
                f"collective {what} failed: {box['error']}") from box["error"]
        return box["value"]

    # -- member threads (real multi-process mode) --------------------------
    def _start_threads(self) -> None:
        hb = threading.Thread(target=self._heartbeat_loop, daemon=True,
                              name="dist-heartbeat")
        wd = threading.Thread(target=self._watchdog_loop, daemon=True,
                              name="dist-watchdog")
        self._threads = [hb, wd]
        hb.start()
        wd.start()

    def _heartbeat_loop(self) -> None:
        """Renew the lease every third of the heartbeat and keep the
        longest gap between two renewals (logged at :meth:`stop`)."""
        period = self.conf.heartbeat_ms / 3000.0
        last = None
        while not self._stop.is_set():
            with contextlib.suppress(OSError):  # transient fs trouble
                self.meshdir.heartbeat(self._inner.process_index,
                                       self.generation, step=self._step)
            now = self._clock.monotonic()
            if last is not None:
                self.beat_gap_max_s = max(self.beat_gap_max_s, now - last)
            last = now
            self._clock.sleep(period)

    def _watchdog_loop(self) -> None:
        period = self.conf.heartbeat_ms / 3000.0
        while not self._stop_watch.is_set():
            try:
                self.check_peers()
            except FencedGenerationError as e:
                if self._stop_watch.is_set():
                    return
                logger.error("dist watchdog: %s — exiting fenced", e)
                logging.shutdown()
                os._exit(FENCED_RC)
            except MemberLostError as e:
                if self._stop_watch.is_set():
                    return
                if self._collectives_done.is_set():
                    self._clock.sleep(period)
                    continue
                # an in-step collective cannot be cancelled: exiting is the
                # only way to unstick this member so the supervisor can
                # re-form the mesh
                logger.error("dist watchdog: %s — aborting step, exiting "
                             "for mesh re-formation", e)
                logging.shutdown()
                os._exit(ABORT_RC)
            except OSError:
                pass  # transient fs trouble: retry next tick
            self._clock.sleep(period)

    def stop(self) -> None:
        """End the watchdog, leave the process group (the lease still
        renewed while that runs), then end the heartbeat and drop the
        lease (module docstring)."""
        self._stop_watch.set()
        try:
            self._inner.stop()
        finally:
            self._stop.set()
            for t in self._threads:
                t.join(timeout=self.conf.heartbeat_ms / 1000.0)
            if self._threads:
                logger.info("dist member %d: lease renewed at most %.1f ms "
                            "apart (expiry %d ms)", self._inner.process_index,
                            self.beat_gap_max_s * 1000.0,
                            self.conf.heartbeat_ms)
            if self.meshdir is not None:
                with contextlib.suppress(OSError):
                    os.unlink(os.path.join(
                        self.meshdir.state_dir,
                        f"member-{int(self._inner.process_index)}.json"))

    def __repr__(self) -> str:
        return (f"DistContext(gen={self.generation}, "
                f"inner={self._inner!r})")
