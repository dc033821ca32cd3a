"""The streaming updater: tail → fold → delta → ship → commit.

Counterpart of ``incubator_predictionio_tpu/streaming/updater.py``
(``UpdaterConfig``, ``ShipError``, ``HttpTransport``, ``StreamUpdater``,
``inspect_state_dir``, ``load_base_model``). One loop iteration
(``run_once``):

1. **Tail** the event log from the crash-safe cursor (``feed.py``). A torn
   tail is "wait and re-poll", never an error.
2. **Fold** the batch through the sparse trainer (``trainer.py``) on the
   updater's device: kernel K3 runs each micro-batch's adam step on a CUDA
   device. Poison events divert to the dead-letter file (WAL frames).
3. **Guard** (``guard.py``): a divergence trip quarantines the stream
   durably BEFORE anything ships.
4. **Archive + ship** the delta (``delta.py``): the artifact lands
   atomically in the state dir, then ships to every replica's ``POST
   /delta`` — each replica first resynced with whatever archived chain it
   is missing.
5. **Commit**: trainer state (tagged with ``to_seq``), then the cursor.

Crash ordering: steps 1–3 are reads and in-memory work; a crash loses
nothing. A crash after 4 but before 5 re-folds the same batch from the same
persisted state — the same delta — and re-ships it; replicas dedupe on the
``[from_seq, to_seq)`` range. A crash between the two commit writes is
detected at load (state ``to_seq`` ahead of the cursor) and the cursor
adopts the state's position.

Fault injection: ``PIO_STREAM_FAULT=kill:<point>`` SIGKILLs this process at
the named point (``after_archive``, ``after_ship``). The reference's trace
spans here, its span spool and its performance plane come with the
updater's plane (the next part of ROADMAP.md Queue 1 item 6); the fold's
``stream.fold`` phases and ``pio_stream_*`` counters are recorded now, and
``stream --obs-port`` serves them.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
import signal
import time
import urllib.error
import urllib.request
from typing import Optional

from incubator_predictionio_tpu_torch.native import format as fmt
from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
from incubator_predictionio_tpu_torch.resilience.wal import (
    MAGIC as WAL_MAGIC,
    tail_frames,
    write_frame,
)
from incubator_predictionio_tpu_torch.streaming import delta as deltas
from incubator_predictionio_tpu_torch.streaming import feed as feeds
from incubator_predictionio_tpu_torch.streaming import guard as guards
from incubator_predictionio_tpu_torch.streaming.stream_metrics import (
    DEAD_LETTER,
    FOLDED,
)
from incubator_predictionio_tpu_torch.streaming.trainer import DeltaTrainer
from incubator_predictionio_tpu_torch.utils.fs import atomic_write_bytes

logger = logging.getLogger(__name__)

TRAINER_STATE = "trainer.pkl"
DEAD_LETTER_FILE = "deadletter.log"


@dataclasses.dataclass
class UpdaterConfig:
    state_dir: str
    feed_path: str
    replicas: tuple[str, ...] = ()
    access_key: Optional[str] = None        # replicas' --server-access-key
    batch_events: int = 512
    poll_interval: float = 1.0
    ship_timeout: float = 60.0
    from_start: bool = False   # fold the whole log instead of tail-only
    micro_batch: int = 256


class ShipError(RuntimeError):
    """A replica could not be brought up to date (transport failure or a
    hard rejection). The loop retries next round — the archived chain is
    the source of truth."""


class HttpTransport:
    """Delta shipping over the replicas' HTTP surface."""

    def __init__(self, access_key: Optional[str] = None,
                 timeout: float = 60.0):
        self.access_key = access_key
        self.timeout = timeout

    def _qs(self) -> str:
        return f"?accessKey={self.access_key}" if self.access_key else ""

    def applied_seq(self, url: str) -> tuple[Optional[int], Optional[str]]:
        """(lastDeltaSeq, baseInstance) from a replica's /health — None
        when the replica has no delta applied yet."""
        with urllib.request.urlopen(f"{url}/health",
                                    timeout=self.timeout) as resp:
            h = json.loads(resp.read())
        dep = h.get("deployment") or {}
        stream = dep.get("streaming") or {}
        return stream.get("lastDeltaSeq"), dep.get("instanceId")

    def ship(self, url: str, payload: bytes) -> dict:
        """POST one encoded delta; returns the replica's parsed answer.
        Raises ShipError on transport failure or non-2xx/409 statuses."""
        headers = {"Content-Type": "application/octet-stream"}
        req = urllib.request.Request(
            f"{url}/delta{self._qs()}", data=payload, method="POST",
            headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            body = e.read()
            try:
                parsed = json.loads(body or b"{}")
            except ValueError:
                parsed = {"raw": body.decode(errors="replace")}
            if e.code == 409:
                parsed["status"] = parsed.get("status", "rejected")
                parsed["httpStatus"] = 409
                return parsed
            raise ShipError(f"{url}: HTTP {e.code} {parsed}") from e
        except OSError as e:
            raise ShipError(f"{url}: {e}") from e


class StreamUpdater:
    """Owns the state dir; one instance per stream (single-writer like the
    event log itself). ``model`` is the deployed base RecModel — the
    updater keeps its own applied copy current for the divergence guard.
    ``ctx`` is the updater's :class:`DeviceContext` (``cuda:0`` unless the
    caller passes another): the trainer folds on its device and the
    guard's recall probe prepares the applied copy there."""

    def __init__(self, config: UpdaterConfig, model, instance_id: str,
                 transport=None,
                 guard: Optional[guards.DivergenceGuard] = None,
                 event_names=("rate", "buy"), default_values=None,
                 ctx: Optional[DeviceContext] = None):
        self.config = config
        self.instance_id = instance_id
        self.ctx = ctx or DeviceContext.create()
        self.transport = transport or HttpTransport(
            config.access_key, config.ship_timeout)
        self.guard = guard or guards.DivergenceGuard()
        os.makedirs(config.state_dir, exist_ok=True)
        self.model = model
        self._handle_instance_change()
        mf = model.mf
        mf.ensure_host()  # a device-resident model's one table pull
        self.trainer = DeltaTrainer(
            mf.user_emb, mf.user_bias, mf.item_emb, mf.item_bias, mf.mean,
            dict(model.user_map.items()), dict(model.item_map.items()),
            learning_rate=mf.config.learning_rate, reg=mf.config.reg,
            event_names=event_names, default_values=default_values,
            coldstart=getattr(model, "coldstart", None),
            micro_batch=config.micro_batch,
            device=self.ctx.device,
        )
        cursor = feeds.read_cursor(config.state_dir)
        state = self._load_trainer_state()
        if state is not None:
            self.trainer.load_state(state["trainer"])
            if cursor is None or state["to_seq"] > cursor["seq"]:
                # crash between the state write and the cursor write: the
                # state is ahead — its delta is archived, adopt its seq
                cursor = {"seq": state["to_seq"],
                          "chain_base": state["chain_base"],
                          "delta_head": state.get("delta_head",
                                                  state["to_seq"]),
                          "base_instance": self.instance_id}
                feeds.write_cursor(config.state_dir, cursor)
        if cursor is None:
            start = (len(fmt.MAGIC) if config.from_start
                     else self._log_end())
            cursor = {"seq": start, "chain_base": start,
                      "delta_head": start,
                      "base_instance": self.instance_id}
            feeds.write_cursor(config.state_dir, cursor)
        cursor.setdefault("delta_head", cursor["seq"])
        self.cursor = cursor
        # re-apply the archived chain to our local model copy: the guard
        # (recall probes, IVF stale-fraction accounting) must see the model
        # the REPLICAS serve, not the freshly loaded base
        for _, _, path in deltas.list_archived(config.state_dir):
            try:
                d = deltas.load_delta(path)
            except ValueError:
                continue  # torn artifact from a crash mid-archive
            if d.base_instance == self.instance_id:
                self.model = self.model.apply_delta(d)
        self.feed = feeds.EventLogFeed(config.feed_path,
                                       from_seq=cursor["seq"])
        self.dead_letter_count = 0
        self.last_result: dict = {}
        # per-replica chain position (docs/sharding.md "Multi-host shard
        # owners"): every ship_chain re-reads the REPLICA's own /health and
        # records its lastDeltaSeq here, keyed by url. Shard owners apply
        # the same chain positions but restrict rows at apply time; a
        # freshly promoted standby answers None/behind and gets its OWN
        # resync — a single global seq would skip (or replay) another
        # owner's chain after a failover promote.
        self.owner_seqs: dict[str, Optional[int]] = {}

    # -- init helpers -----------------------------------------------------
    def _log_end(self) -> int:
        try:
            with open(self.config.feed_path, "rb") as f:
                buf = f.read()
            return fmt.valid_extent(buf)
        except (FileNotFoundError, ValueError):
            return len(fmt.MAGIC)

    def _handle_instance_change(self) -> None:
        """A full retrain (new instance id) resets chain, state, and any
        quarantine — the new base model supersedes the old stream."""
        cursor = feeds.read_cursor(self.config.state_dir)
        q = guards.read_quarantine(self.config.state_dir)
        stale = (cursor is not None
                 and cursor.get("base_instance") != self.instance_id)
        if q is not None and q.get("baseInstance") != self.instance_id:
            guards.clear_quarantine(self.config.state_dir)
            q = None
            stale = stale or cursor is not None
        if stale:
            logger.info("streaming: base instance changed (%s -> %s); "
                        "resetting delta chain",
                        cursor.get("base_instance"), self.instance_id)
            self._reset_state()

    def _reset_state(self) -> None:
        import shutil

        for name in (feeds.CURSOR_FILE, TRAINER_STATE):
            try:
                os.remove(os.path.join(self.config.state_dir, name))
            except FileNotFoundError:
                pass
        shutil.rmtree(deltas.archive_dir(self.config.state_dir),
                      ignore_errors=True)

    # -- persistence ------------------------------------------------------
    def _trainer_state_path(self) -> str:
        return os.path.join(self.config.state_dir, TRAINER_STATE)

    def _load_trainer_state(self) -> Optional[dict]:
        try:
            with open(self._trainer_state_path(), "rb") as f:
                return pickle.load(f)
        except (FileNotFoundError, EOFError, pickle.UnpicklingError):
            return None

    def _commit(self, to_seq: int,
                delta_head: Optional[int] = None) -> None:
        """State first (tagged ahead), then the cursor — the ordering the
        crash-recovery in __init__ relies on. ``delta_head`` advances only
        when a delta was archived for this batch; empty commits (ignored
        events, tombstones) move the FEED cursor but leave the chain head
        where it is, so the next delta's ``from_seq`` spans the gap and
        the replicas' contiguity check never wedges."""
        head = (delta_head if delta_head is not None
                else self.cursor["delta_head"])
        atomic_write_bytes(
            self._trainer_state_path(),
            pickle.dumps({
                "to_seq": to_seq,
                "chain_base": self.cursor["chain_base"],
                "delta_head": head,
                "trainer": self.trainer.to_state(),
            }, protocol=pickle.HIGHEST_PROTOCOL),
            durable=True)
        self.cursor = {**self.cursor, "seq": to_seq, "delta_head": head,
                       "base_instance": self.instance_id}
        feeds.write_cursor(self.config.state_dir, self.cursor)

    def _dead_letter(self, events, reason: str) -> None:
        """WAL-frame dead letters, the spill queue's discipline: durable,
        inspectable (``pio-tpu stream --dead-letter``), never silently
        dropped."""
        if not events:
            return
        path = os.path.join(self.config.state_dir, DEAD_LETTER_FILE)
        fresh = not os.path.exists(path)
        # the WAL frame discipline: MAGIC header + CRC-framed appends
        with open(path, "ab") as f:
            if fresh:
                f.write(WAL_MAGIC)
            for e in events:
                rec = {"event": e.to_json_dict(), "reason": reason,
                       "seqRange": [self.cursor["seq"], None]}
                write_frame(f, json.dumps(
                    rec, separators=(",", ":")).encode())
            f.flush()
            os.fsync(f.fileno())
        self.dead_letter_count += len(events)
        DEAD_LETTER.inc(len(events))
        logger.warning("streaming: dead-lettered %d poison event(s): %s",
                       len(events), reason)

    def _maybe_fault(self, point: str) -> None:
        if os.environ.get("PIO_STREAM_FAULT") == f"kill:{point}":
            logger.error("PIO_STREAM_FAULT tripping at %s — SIGKILL", point)
            os.kill(os.getpid(), signal.SIGKILL)

    # -- shipping ---------------------------------------------------------
    def ship_chain(self, url: str) -> dict:
        """Bring one replica up to date from the archived chain. The
        replica's /health names what it has; we send, in order, everything
        past that — duplicates (crash replay) come back as counted dedups."""
        applied, instance = self.transport.applied_seq(url)
        if instance is not None and instance != self.instance_id:
            raise ShipError(
                f"{url}: serves instance {instance}, chain is for "
                f"{self.instance_id} (deploy/reload the base model first)")
        self.owner_seqs[url] = applied
        paths = deltas.chain_from(self.config.state_dir, applied)
        shipped = deduped = 0
        last_to = applied
        for path in paths:
            with open(path, "rb") as f:
                answer = self.transport.ship(url, f.read())
            status = answer.get("status")
            if status in ("applied", "ok"):
                shipped += 1
            elif status == "duplicate":
                deduped += 1
            else:
                raise ShipError(f"{url}: delta {os.path.basename(path)} "
                                f"rejected: {answer}")
            seq = answer.get("lastDeltaSeq")
            if seq is not None:
                last_to = seq
        # record where THIS replica's chain now stands — per replica, never
        # a fleet-global seq
        self.owner_seqs[url] = last_to
        return {"url": url, "shipped": shipped, "deduped": deduped,
                "lastDeltaSeq": last_to}

    def ship_all(self) -> list[dict]:
        out = []
        for url in self.config.replicas:
            try:
                out.append(self.ship_chain(url))
            except ShipError as e:
                logger.warning("streaming: ship failed — %s", e)
                out.append({"url": url, "error": str(e)})
        return out

    # -- the loop ---------------------------------------------------------
    @property
    def quarantined(self) -> Optional[dict]:
        return guards.read_quarantine(self.config.state_dir)

    def run_once(self) -> dict:
        q = self.quarantined
        if q is not None:
            self.last_result = {"status": "quarantined", "marker": q}
            return self.last_result
        batch = self.feed.poll(self.config.batch_events)
        if not batch.events:
            ships = self.ship_all() if self.config.replicas else []
            if batch.to_seq > self.cursor["seq"]:
                self._commit(batch.to_seq)  # tombstones/interns only
            self.last_result = {
                "status": "waiting" if batch.waiting else "idle",
                "cursor": self.cursor["seq"], "ships": ships}
            return self.last_result
        return self._fold_and_ship(batch)

    def _fold_and_ship(self, batch) -> dict:
        result, poison = self.trainer.fold(batch.events)
        if poison:
            self._dead_letter(poison, "fold rejected (poison event)")
        FOLDED.inc(result.n_folded)
        fold_rows = {}
        for kind, rows in (("u", result.user_rows), ("i", result.item_rows),
                           ("cu", result.cold_user_rows),
                           ("ci", result.cold_item_rows)):
            for idx, row in rows.items():
                fold_rows[(kind, idx)] = row
        reason = self.guard.check_fold(self.trainer, fold_rows)
        if reason is not None:
            marker = guards.quarantine(
                self.config.state_dir, reason, batch.from_seq,
                self.instance_id)
            self.last_result = {"status": "quarantined", "marker": marker}
            return self.last_result
        if not fold_rows:
            # nothing trainable (all ignored/unknown with cold-start off):
            # advance the cursor so the window isn't re-read forever
            self._commit(batch.to_seq)
            self.last_result = {"status": "empty", "cursor": batch.to_seq,
                                "skipped": result.n_skipped,
                                "ignored": result.n_ignored}
            return self.last_result
        d = deltas.ModelDelta(
            base_instance=self.instance_id,
            chain_base=self.cursor["chain_base"],
            # from_seq is the CHAIN head, not the batch start: untrainable
            # stretches the cursor skipped (all-ignored batches, tombstone
            # runs) are covered by the next real delta, keeping the chain
            # contiguous for the replicas' exactly-once check
            from_seq=self.cursor["delta_head"], to_seq=batch.to_seq,
            user_rows=result.user_rows, item_rows=result.item_rows,
            cold_user_rows=result.cold_user_rows,
            cold_item_rows=result.cold_item_rows,
            max_event_time_us=result.max_event_time_us,
            n_events=result.n_folded,
        )
        deltas.save_delta(self.config.state_dir, d)
        self._maybe_fault("after_archive")
        # keep the updater's own applied model current (guard probes it)
        self.model = self.model.apply_delta(d)
        recall_trip = self.guard.maybe_check_recall(self.model,
                                                    self.ctx.device)
        if recall_trip is not None:
            marker = guards.quarantine(
                self.config.state_dir, recall_trip, batch.from_seq,
                self.instance_id)
            self.last_result = {"status": "quarantined", "marker": marker}
            return self.last_result
        ships = self.ship_all()
        self._maybe_fault("after_ship")
        self._commit(batch.to_seq, delta_head=d.to_seq)
        self.last_result = {
            "status": "applied",
            "fromSeq": d.from_seq, "toSeq": d.to_seq,
            "events": result.n_folded, "rows": d.n_rows,
            "skipped": result.n_skipped, "ignored": result.n_ignored,
            "deadLettered": len(poison),
            "ships": ships, "cursor": self.cursor["seq"],
        }
        return self.last_result

    def run_forever(self, max_batches: Optional[int] = None) -> None:
        n = 0
        while True:
            out = self.run_once()
            if out["status"] == "quarantined":
                logger.error("streaming quarantined: %s — exiting loop",
                             out["marker"]["reason"])
                return
            if out["status"] == "applied":
                n += 1
                logger.info("streaming: %s", out)
                if max_batches is not None and n >= max_batches:
                    return
            # "waiting" (writer mid-append) backs off exactly like "idle":
            # no progress is possible until the writer acts, and a 0s
            # re-poll would busy-spin a core on the same partial frame
            time.sleep(self.config.poll_interval
                       if out["status"] in ("idle", "waiting") else 0.0)

    def status(self) -> dict:
        return {
            "stateDir": os.path.abspath(self.config.state_dir),
            "feedPath": self.config.feed_path,
            "cursor": self.cursor,
            "foldedEvents": self.trainer.n_folded,
            "overlayRows": len(self.trainer.rows),
            "archivedDeltas": len(
                deltas.list_archived(self.config.state_dir)),
            "deadLettered": self.dead_letter_count,
            "quarantine": self.quarantined,
            "replicas": list(self.config.replicas),
            # per-replica chain positions from the last resync (None =
            # replica reported nothing applied yet)
            "ownerSeqs": dict(self.owner_seqs),
        }


def inspect_state_dir(state_dir: str) -> dict:
    """Read-only snapshot of a stream state dir for ``pio-tpu stream
    --status``: cursor, chain, quarantine, archive and dead-letter tallies
    — no model load, no cursor creation, no instance-change reset. Safe
    against a live updater."""
    cursor = feeds.read_cursor(state_dir)
    dl_path = os.path.join(state_dir, DEAD_LETTER_FILE)
    dead = 0
    dl_defect = None
    if os.path.exists(dl_path):
        records, _, status = tail_frames(dl_path)
        dead = len(records)
        if status == "corrupt":
            dl_defect = "corrupt frame past the readable records"
    archived = deltas.list_archived(state_dir)
    return {
        "stateDir": os.path.abspath(state_dir),
        "cursor": cursor,
        "archivedDeltas": len(archived),
        "chainHead": archived[-1][1] if archived else None,
        "deadLettered": dead,
        "deadLetterDefect": dl_defect,
        "quarantine": guards.read_quarantine(state_dir),
    }


def load_base_model(engine_variant: str, storage=None,
                    ctx: Optional[DeviceContext] = None):
    """(RecModel-like model, instance_id, event names, rating defaults) of
    the latest COMPLETED instance — the resolution deploy uses, minus
    warmup (the updater never serves queries), prepared on ``ctx``'s
    device (``cuda:0`` unless the caller passes another)."""
    from incubator_predictionio_tpu_torch.server.query_server import (
        ServerConfig,
        load_deployed_engine,
    )

    deployed = load_deployed_engine(
        ServerConfig(engine_variant=engine_variant), storage, ctx,
        warmup=False)
    model = next(
        (m for m in deployed.models if hasattr(m, "apply_delta")), None)
    if model is None:
        raise RuntimeError(
            "no deployed model supports streaming deltas (need a "
            "RecModel-style model exposing apply_delta)")
    ds_params = deployed.engine_params.data_source_params[1]
    event_names = tuple(getattr(ds_params, "event_names", ("rate", "buy")))
    defaults = None
    getter = getattr(ds_params, "rating_defaults", None)
    if callable(getter):
        defaults = getter()
    return model, deployed.instance.id, event_names, defaults
