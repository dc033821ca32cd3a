"""Multi-process launcher — the ``Runner.runOnSpark`` counterpart.

Counterpart of ``incubator_predictionio_tpu/parallel/launcher.py`` (:1-140):
scale-out is N identical processes running the SAME CLI verb, joined into
one ``torch.distributed`` group, where the reference forks
``spark-submit`` (tools/Runner.scala:185-335). Each spawned process gets

- ``PIO_DIST_COORDINATOR`` — host:port of the rendezvous (process 0 binds it);
- ``PIO_DIST_NUM_PROCESSES`` / ``PIO_DIST_PROCESS_ID`` — the job topology;

consumed by :func:`incubator_predictionio_tpu_torch.parallel.mesh.
init_distributed_from_env` when the verb builds its DeviceContext with
``distributed=True``. Storage writes happen only on process 0
(``DeviceContext.is_primary``), the reference's single Spark driver.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Optional, Sequence

CLI_MODULE = "incubator_predictionio_tpu_torch.tools.cli"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class LaunchResult:
    returncodes: list[int]
    outputs: list[str]  # combined stdout+stderr per process
    timed_out: bool = False  # deadline hit; unfinished processes got rc=124

    @property
    def ok(self) -> bool:
        return not self.timed_out and all(rc == 0 for rc in self.returncodes)


def launch_local(
    cli_args: Sequence[str],
    num_processes: int,
    coordinator_port: Optional[int] = None,
    cpu_devices_per_process: Optional[int] = None,
    env: Optional[dict[str, str]] = None,
    timeout: Optional[float] = None,
    command: Optional[Sequence[str]] = None,
) -> LaunchResult:
    """Run ``<cli> <cli_args>`` as ``num_processes`` coordinated processes.

    ``cpu_devices_per_process=1`` runs the processes on the CPU (each child
    gets ``--device cpu``); the port has one device a process, so any
    other value raises. Leave it ``None`` on the card. Processes run
    concurrently and are all waited on; the output of each is captured in
    a temp file. On the deadline the whole job is killed: the unfinished
    processes get rc 124 and the logs are kept. ``command`` replaces the
    default ``python -m <cli> <cli_args>`` argv entirely (same coordination
    env; ``cli_args`` unused)."""
    if num_processes < 1:
        raise ValueError("num_processes must be >= 1")
    if cpu_devices_per_process not in (None, 1):
        raise ValueError(
            f"cpu_devices_per_process={cpu_devices_per_process}: the port runs "
            "one device a process (1 runs the processes on the CPU)")
    port = coordinator_port or free_port()
    argv = (list(command) if command is not None
            else [sys.executable, "-m", CLI_MODULE, *cli_args])
    if cpu_devices_per_process and command is None:
        argv += ["--device", "cpu"]
    procs: list[subprocess.Popen] = []
    # capture into temp files, not pipes: a child blocked on a full pipe
    # blocks its collectives, which stalls every coordinated peer — a
    # deadlock no sequential drain order can avoid (reference :79-82)
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(num_processes)]
    try:
        for pid in range(num_processes):
            penv = dict(os.environ)
            if env:
                penv.update(env)
            penv["PIO_DIST_COORDINATOR"] = f"127.0.0.1:{port}"
            penv["PIO_DIST_NUM_PROCESSES"] = str(num_processes)
            penv["PIO_DIST_PROCESS_ID"] = str(pid)
            procs.append(subprocess.Popen(
                argv, env=penv, stdout=logs[pid], stderr=subprocess.STDOUT,
                text=True))
        returncodes, timed_out = _wait_all(procs, timeout)
    finally:
        for p in procs:  # nothing outlives the launch, whatever raised
            if p.poll() is None:
                p.kill()
                p.wait()
        outputs = []
        for f in logs:
            f.seek(0)
            outputs.append(f.read())
            f.close()
    return LaunchResult(returncodes, outputs, timed_out=timed_out)


def _wait_all(procs: list[subprocess.Popen],
              timeout: Optional[float]) -> tuple[list[int], bool]:
    """Wait for every process; past the deadline kill the job and return
    rc 124 for the processes that had not finished."""
    deadline = None if timeout is None else time.monotonic() + timeout
    for p in procs:
        remaining = None if deadline is None else deadline - time.monotonic()
        try:
            if remaining is not None and remaining <= 0:
                raise subprocess.TimeoutExpired(p.args, timeout or 0)
            p.wait(timeout=remaining)
        except subprocess.TimeoutExpired:
            killed = set()
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
                    killed.add(id(q))
            return [124 if id(q) in killed else q.returncode
                    for q in procs], True
    return [p.returncode for p in procs], False
