"""Supervisor — forms, watches and re-forms a distributed training mesh.

Counterpart of ``incubator_predictionio_tpu/distributed/supervisor.py``
(:class:`Supervisor`, :class:`SupervisorResult`). ``launch_local`` runs a
coordinated job and waits; the supervisor is its fault-tolerant sibling:
it spawns the N member processes of the port's CLI
(``parallel/launcher.py:CLI_MODULE``), polls them, and treats any
non-zero exit before the group finishes as a mesh loss:

1. record the detection time and kill the survivors (their in-step
   collectives can never complete once a peer is gone);
2. bump the mesh **generation** in the coordination directory, durable
   BEFORE any relaunch, so a zombie that survived the kill is fenced out
   of commits and collectives, and clear the members' leases;
3. relaunch all N members on a FRESH coordinator port with
   ``PIO_DIST_GENERATION`` advanced; the members resume from the last
   committed slice checkpoint.

Each member gets ``PIO_DIST_COORDINATOR``, ``PIO_DIST_NUM_PROCESSES``,
``PIO_DIST_PROCESS_ID``, ``PIO_DIST_STATE_DIR``, ``PIO_DIST_GENERATION``
and ``PIO_DIST_HEARTBEAT_MS``; ``cpu_devices_per_process=1`` runs them on
the CPU (``--device cpu``, as ``launch --cpu-devices-per-process`` does).
Recovery is bounded by ``max_recoveries``; each recovery's MTTR (detect →
new mesh spawned) is recorded. Member output goes to per-member,
per-generation log files under ``<state_dir>/logs/``. The class has no
CLI verb, as in the reference.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
from dataclasses import dataclass
from typing import Optional, Sequence

from incubator_predictionio_tpu_torch.distributed import dist_metrics
from incubator_predictionio_tpu_torch.distributed.meshdir import MeshDirectory
from incubator_predictionio_tpu_torch.parallel.launcher import CLI_MODULE, free_port
from incubator_predictionio_tpu_torch.resilience.clock import SYSTEM_CLOCK, Clock

logger = logging.getLogger(__name__)

#: supervision poll cadence: member exits are detected within this
_POLL_S = 0.1


@dataclass
class SupervisorResult:
    """What a supervised run proved."""

    ok: bool
    returncodes: list[int]          # final generation's exit codes
    recoveries: int                 # mesh re-formations performed
    mttr_s: list[float]             # detect → respawn, one per recovery
    generation: int                 # generation that finished (or gave up)
    log_paths: list[str]            # every member log, all generations
    timed_out: bool = False
    detail: str = ""

    def logs_text(self, rank: Optional[int] = None) -> str:
        """Concatenated member logs (optionally one rank's only), newest
        generation last."""
        out = []
        for p in self.log_paths:
            if rank is not None and f"member-{rank}." not in os.path.basename(p):
                continue
            try:
                with open(p, "r", errors="replace") as f:
                    out.append(f.read())
            except OSError:
                continue
        return "\n".join(out)


class Supervisor:
    """Drive one distributed train job to completion through member losses."""

    def __init__(
        self,
        cli_args: Sequence[str],
        num_processes: int,
        state_dir: str,
        heartbeat_ms: int = 2000,
        max_recoveries: int = 2,
        cpu_devices_per_process: Optional[int] = None,
        env: Optional[dict[str, str]] = None,
        timeout: Optional[float] = None,
        clock: Clock = SYSTEM_CLOCK,
        command: Optional[Sequence[str]] = None,
        should_abort=None,
    ):
        if num_processes < 1:
            raise ValueError("num_processes must be >= 1")
        if cpu_devices_per_process not in (None, 1):
            raise ValueError(
                f"cpu_devices_per_process={cpu_devices_per_process}: the port "
                "runs one device a process (1 runs the members on the CPU)")
        self.cli_args = list(cli_args)
        self.num_processes = num_processes
        self.meshdir = MeshDirectory(state_dir)
        self.heartbeat_ms = heartbeat_ms
        self.max_recoveries = max_recoveries
        self.cpu_devices_per_process = cpu_devices_per_process
        self.env = dict(env or {})
        self.timeout = timeout
        self._clock = clock
        self.command = list(command) if command is not None else None
        #: checked each poll; True aborts the whole run (an owner that lost
        #: its lease must not keep training in the background)
        self.should_abort = should_abort
        self.log_dir = os.path.join(self.meshdir.state_dir, "logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self._procs: list[subprocess.Popen] = []
        self._log_files: list = []
        self._log_paths: list[str] = []

    # -- lifecycle ---------------------------------------------------------
    def run(self) -> SupervisorResult:
        recoveries = 0
        mttrs: list[float] = []
        deadline = (None if self.timeout is None
                    else self._clock.monotonic() + self.timeout)
        generation = self.meshdir.bump_generation(self.num_processes)
        self._spawn(generation)
        try:
            while True:
                rcs = [p.poll() for p in self._procs]
                if all(rc == 0 for rc in rcs):
                    return self._result(True, recoveries, mttrs, generation)
                if self.should_abort is not None and self.should_abort():
                    self._kill_all()
                    return self._result(
                        False, recoveries, mttrs, generation,
                        detail="aborted by owner (lease/fence lost)")
                if deadline is not None and self._clock.monotonic() >= deadline:
                    self._kill_all()
                    return self._result(False, recoveries, mttrs, generation,
                                        timed_out=True, detail="timeout")
                dead = [(r, rc) for r, rc in enumerate(rcs)
                        if rc is not None and rc != 0]
                if dead:
                    t_detect = self._clock.monotonic()
                    dist_metrics.DIST_STEP_ABORTS.inc()
                    logger.warning(
                        "dist supervisor: member loss in generation %d: %s",
                        generation,
                        ", ".join(f"rank {r} rc={rc}" for r, rc in dead))
                    self._kill_all()
                    if recoveries >= self.max_recoveries:
                        return self._result(
                            False, recoveries, mttrs, generation,
                            detail=f"member loss after {recoveries} "
                                   "recoveries (budget exhausted)")
                    # fence first, spawn second: a zombie must read the new
                    # generation before any new-mesh member can commit
                    generation = self.meshdir.bump_generation(
                        self.num_processes)
                    self.meshdir.clear_members()
                    recoveries += 1
                    self._spawn(generation)
                    mttrs.append(self._clock.monotonic() - t_detect)
                    logger.warning(
                        "dist supervisor: mesh re-formed as generation %d "
                        "(recovery %d, MTTR %.2fs)",
                        generation, recoveries, mttrs[-1])
                self._clock.sleep(_POLL_S)
        finally:
            self._kill_all()
            self._close_logs()

    def alive_pids(self) -> dict[int, int]:
        """rank → pid of the running members (what a chaos test aims its
        SIGKILL with)."""
        return {r: p.pid for r, p in enumerate(self._procs)
                if p.poll() is None}

    # -- internals ---------------------------------------------------------
    def _spawn(self, generation: int) -> None:
        port = free_port()
        dist_metrics.DIST_GENERATION.set(generation)
        dist_metrics.DIST_MEMBERS.set(self.num_processes)
        argv = (self.command if self.command is not None
                else [sys.executable, "-m", CLI_MODULE, *self.cli_args])
        if self.cpu_devices_per_process and self.command is None:
            argv = [*argv, "--device", "cpu"]
        self._close_logs()  # the previous generation's
        self._procs = []
        self._log_files = []
        for rank in range(self.num_processes):
            penv = dict(os.environ)
            penv.update(self.env)
            penv["PIO_DIST_COORDINATOR"] = f"127.0.0.1:{port}"
            penv["PIO_DIST_NUM_PROCESSES"] = str(self.num_processes)
            penv["PIO_DIST_PROCESS_ID"] = str(rank)
            penv["PIO_DIST_STATE_DIR"] = self.meshdir.state_dir
            penv["PIO_DIST_GENERATION"] = str(generation)
            penv["PIO_DIST_HEARTBEAT_MS"] = str(self.heartbeat_ms)
            path = os.path.join(self.log_dir,
                                f"member-{rank}.gen-{generation}.log")
            # append mode: the file doubles as the capture sink (pipes
            # deadlock coordinated peers, see parallel/launcher.py)
            f = open(path, "a")
            self._log_files.append(f)
            self._log_paths.append(path)
            self._procs.append(subprocess.Popen(
                argv, env=penv, stdout=f, stderr=subprocess.STDOUT, text=True))

    def _kill_all(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.kill()
        for p in self._procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    logger.error("dist supervisor: pid %d did not exit "
                                 "30 s after SIGKILL", p.pid)

    def _close_logs(self) -> None:
        for f in self._log_files:
            try:
                f.close()
            except OSError:
                pass

    def _result(self, ok: bool, recoveries: int, mttrs: list[float],
                generation: int, timed_out: bool = False,
                detail: str = "") -> SupervisorResult:
        dist_metrics.DIST_MEMBERS.set(
            sum(1 for p in self._procs if p.poll() is None))
        return SupervisorResult(
            ok=ok,
            returncodes=[(-1 if p.poll() is None else p.returncode)
                         for p in self._procs],
            recoveries=recoveries,
            mttr_s=mttrs,
            generation=generation,
            log_paths=list(self._log_paths),
            timed_out=timed_out,
            detail=detail,
        )
