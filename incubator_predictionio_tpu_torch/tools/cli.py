"""``pio-tpu`` console of the port, cut to the train → eval → deploy path.

Counterpart of ``incubator_predictionio_tpu/tools/cli.py`` (reference
tools/console/Console.scala): the verbs ``app new``, ``import``, ``train``,
``eval``, ``deploy``, ``undeploy``, ``stream``, ``batchpredict``,
``launch``, ``dist status``, ``shards``, ``status``, ``metrics`` and
``profile``, with the reference's argument names (its cli.py:58, :231,
:267, :295, :349, :824, :366, :631, :3786, :3604, :3533, :650, :1683,
:1742). Not yet here: ``status``'s jobs rows and ``metrics --fleet`` (item
7), and the ``history``, ``slo``, ``top`` and ``trace`` verbs (the next
part of ROADMAP.md item 6).
``train``, ``eval``, ``deploy``, ``stream``, ``batchpredict`` and
``shards`` run on the card unless ``--device cpu`` asks for the CPU.
``launch -n N <verb> …`` runs N
coordinated ``<verb> --distributed`` processes of ``train``, ``eval`` or
``batchpredict`` (``parallel/launcher.py``). Run it as ``python -m
incubator_predictionio_tpu_torch.tools.cli <verb>``; :func:`main` takes the
arguments, so a caller can run a verb in-process.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
from typing import Optional

from incubator_predictionio_tpu_torch.data.storage.base import AccessKey, App
from incubator_predictionio_tpu_torch.data.storage.registry import (
    Storage,
    get_storage,
)


def _out(msg: str) -> None:
    print(msg)


def _err(msg: str) -> None:
    print(msg, file=sys.stderr)


def cmd_app_new(args, storage: Storage) -> int:
    """(commands/App.scala:31-90)"""
    apps = storage.get_meta_data_apps()
    if apps.get_by_name(args.name) is not None:
        _err(f"App {args.name} already exists. Aborting.")
        return 1
    app_id = apps.insert(App(args.id or 0, args.name, args.description))
    if app_id is None:
        _err("Unable to create new app.")
        return 1
    storage.get_events().init(app_id)
    key = storage.get_meta_data_access_keys().insert(
        AccessKey(args.access_key or "", app_id, ()))
    _out(f"Initialized Event Store for this app ID: {app_id}.")
    _out("Created new app:")
    _out(f"      Name: {args.name}")
    _out(f"        ID: {app_id}")
    _out(f"Access Key: {key}")
    return 0


def cmd_import(args, storage: Storage) -> int:
    from incubator_predictionio_tpu_torch.tools.export_import import import_events

    channel_id = _resolve_channel(args, storage)
    n = import_events(args.appid, args.input, channel_id, storage)
    _out(f"Imported {n} events.")
    return 0


def _resolve_channel(args, storage: Storage) -> Optional[int]:
    if not getattr(args, "channel", None):
        return None
    channels = storage.get_meta_data_channels().get_by_app_id(args.appid)
    channel = next((c for c in channels if c.name == args.channel), None)
    if channel is None:
        raise SystemExit(f"Channel {args.channel} does not exist for app {args.appid}")
    return channel.id


def _mesh_axes(args) -> Optional[dict]:
    """``--mesh-axes`` as a dict (reference cli.py:237), or None."""
    return json.loads(args.mesh_axes) if args.mesh_axes else None


def cmd_train(args, storage: Storage) -> int:
    from incubator_predictionio_tpu_torch.core.workflow.create_workflow import (
        WorkflowConfig,
        create_workflow,
    )

    config = WorkflowConfig(
        engine_variant=args.engine_variant,
        batch=args.batch,
        verbose=args.verbose,
        skip_sanity_check=args.skip_sanity_check,
        stop_after_read=args.stop_after_read,
        stop_after_prepare=args.stop_after_prepare,
        device=args.device,
        distributed=args.distributed,
        mesh_axes=_mesh_axes(args),
    )
    if args.profile_dir:
        from incubator_predictionio_tpu_torch.utils.tracing import (
            profile_trace,
        )

        trace = profile_trace(args.profile_dir)
    else:
        trace = contextlib.nullcontext()
    with trace:
        instance_id = create_workflow(config, storage)
    if args.profile_dir:
        _out(f"Profiler trace written to {args.profile_dir} "
             "(torch.profiler, TensorBoard's PyTorch profiler layout).")
    if instance_id == "<secondary>":
        _out("Training completed (secondary process; the primary wrote the "
             "engine instance).")
    else:
        _out(f"Training completed. Engine instance ID: {instance_id}")
    return 0


def cmd_eval(args, storage: Storage) -> int:
    """(commands/Engine.scala eval; reference cli.py:267-293)"""
    from incubator_predictionio_tpu_torch.core.workflow.create_workflow import (
        WorkflowConfig,
        create_workflow,
    )

    config = WorkflowConfig(
        engine_variant=args.engine_variant,
        evaluation_class=args.evaluation_class,
        engine_params_generator_class=args.engine_params_generator_class,
        batch=args.batch,
        device=args.device,
        fast_eval=not args.no_fast_eval,
        distributed=args.distributed,
        mesh_axes=_mesh_axes(args),
    )
    instance_id = create_workflow(config, storage)
    if instance_id == "<secondary>":
        _out("Evaluation completed (secondary process; the primary wrote "
             "the evaluation instance).")
        return 0
    inst = storage.get_meta_data_evaluation_instances().get(instance_id)
    _out(f"Evaluation completed. Instance ID: {instance_id}")
    if inst is not None and inst.evaluator_results:
        _out(inst.evaluator_results)
    return 0


def cmd_deploy(args, storage: Storage) -> int:
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
    from incubator_predictionio_tpu_torch.server.query_server import (
        ServerConfig,
        serve_forever,
    )

    config = ServerConfig(
        engine_variant=args.engine_variant,
        ip=args.ip,
        port=args.port,
        server_access_key=args.server_access_key,
        query_timeout_sec=args.query_timeout_sec,
        algo_deadline_sec=args.algo_deadline_sec,
        algo_breaker_threshold=args.algo_breaker_threshold,
        algo_breaker_reset_sec=args.algo_breaker_reset_sec,
        smoke_queries=tuple(
            json.loads(q) for q in (args.smoke_query or ())),
        reload_probation_sec=args.reload_probation_sec,
        # unset flags keep the PIO_ADMISSION_* environment defaults
        **{k: v for k, v in (
            ("admission_max_queue", args.admission_max_queue),
            ("admission_target_ms", args.admission_target_ms),
        ) if v is not None},
        **({"admission_adaptive": False}
           if args.no_adaptive_admission else {}),
    )
    serve_forever(config, storage, DeviceContext.create(args.device))
    return 0


def cmd_undeploy(args, storage: Storage) -> int:
    """``POST /stop`` to a deployed engine server (reference cli.py:349):
    it drains, then exits."""
    import urllib.request

    url = f"http://{args.ip}:{args.port}/stop"
    if args.server_access_key:
        url += f"?accessKey={args.server_access_key}"
    try:
        with urllib.request.urlopen(
            urllib.request.Request(url, method="POST"), timeout=10
        ) as resp:
            _out(resp.read().decode())
        return 0
    except Exception as e:  # noqa: BLE001
        _err(f"Undeploy failed: {e}")
        return 1


def cmd_stream(args, storage: Storage) -> int:
    """Streaming incremental updates (reference cli.py:824): tail the
    event-log change feed, fold events into embedding-row deltas on the
    card (``--device`` elsewhere), and ship them to the ``--replica``
    servers' ``POST /delta``, crash-safe and exactly-once (cursor and delta
    archive live in ``--state-dir``).

    ``--status`` prints the stream state (cursor, quarantine, dead letters)
    without folding; ``--dead-letter`` prints the dead-lettered events as
    JSON lines; ``--once`` runs one poll → fold → ship → commit round and
    exits. After start-up the process's heap is frozen out of the garbage
    collector's reach (``gc.freeze()``), so no full collection of it lands
    inside a fold."""
    import gc

    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
    from incubator_predictionio_tpu_torch.streaming.feed import (
        resolve_feed_path,
    )
    from incubator_predictionio_tpu_torch.streaming.updater import (
        DEAD_LETTER_FILE,
        StreamUpdater,
        UpdaterConfig,
        inspect_state_dir,
        load_base_model,
    )

    if args.status:
        # strictly read-only: no model load, no cursor creation
        info = inspect_state_dir(args.state_dir)
        _out(json.dumps(info, indent=2, default=str))
        return 1 if info["quarantine"] else 0
    if args.dead_letter:
        from incubator_predictionio_tpu_torch.resilience.wal import tail_frames

        path = os.path.join(args.state_dir, DEAD_LETTER_FILE)
        if not os.path.exists(path):
            _out("No dead letters.")
            return 0
        records, _, status = tail_frames(path)
        for _, rec in records:
            _out(json.dumps(rec))
        if status == "corrupt":
            _err("dead-letter file has a corrupt frame past the listed "
                 "records")
            return 1
        return 0
    ctx = DeviceContext.create(args.device)
    model, instance_id, event_names, defaults = load_base_model(
        args.engine_variant, storage, ctx)
    feed_path = args.feed_path or resolve_feed_path(
        storage, args.app, args.channel)
    cfg = UpdaterConfig(
        state_dir=args.state_dir,
        feed_path=feed_path,
        replicas=tuple(args.replica or ()),
        access_key=args.server_access_key,
        batch_events=args.batch_events,
        poll_interval=args.interval,
        from_start=args.from_start,
    )
    updater = StreamUpdater(cfg, model, instance_id,
                            event_names=event_names,
                            default_values=defaults, ctx=ctx)
    obs_handle = None
    if args.obs_port:
        # the updater has no HTTP surface of its own; this thread serves
        # the shared /metrics, /traces.json and /profile.json, so
        # pio_stream_* and the stream.fold phases are scrapeable
        from incubator_predictionio_tpu_torch.obs.http import start_obs_server

        obs_handle = start_obs_server("stream_updater", args.obs_port,
                                      ip=args.obs_ip)
    gc.collect()
    gc.freeze()
    try:
        if args.once:
            out = updater.run_once()
            _out(json.dumps(out, default=str))
            return 1 if out["status"] == "quarantined" else 0
        updater.run_forever(max_batches=args.max_batches)
        return 1 if updater.quarantined else 0
    finally:
        if obs_handle is not None:
            obs_handle.close()
        from incubator_predictionio_tpu_torch.ops import retrieval, sparse_update

        logging.getLogger(__name__).info(
            "stream: kernel launches %s", json.dumps({
                w.__name__: w.launches for w in (
                    *sparse_update.KERNEL_WRAPPERS,
                    *retrieval.KERNEL_WRAPPERS)}))


def cmd_batchpredict(args, storage: Storage) -> int:
    """(BatchPredict.scala; reference cli.py:366-396)"""
    from incubator_predictionio_tpu_torch.core.workflow.batch_predict import (
        BatchPredictConfig,
        part_path,
        run_batch_predict,
    )
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext

    # under `launch -n N batchpredict` each process scores a slice and
    # writes <output>.part-<pid>
    ctx = DeviceContext.create(args.device, distributed=args.distributed,
                               axes=_mesh_axes(args))
    try:
        n = run_batch_predict(
            BatchPredictConfig(
                engine_variant=args.engine_variant,
                input_path=args.input,
                output_path=args.output,
                query_chunk=args.query_partitions or 1024,
            ),
            storage,
            ctx,
        )
    finally:
        ctx.stop()
    if ctx.process_count > 1:
        _out(f"Batch predict completed: {n} predictions written to "
             f"{part_path(args.output, ctx.process_index)} "
             f"(slice {ctx.process_index + 1}/{ctx.process_count})")
    else:
        _out(f"Batch predict completed: {n} predictions written to {args.output}")
    return 0


def cmd_launch(args, storage: Storage) -> int:
    """Spawn N coordinated processes of another verb (Runner.scala:185's
    spark-submit construction, minus the JVM; reference cli.py:3786-3819)
    and print each one's output."""
    from incubator_predictionio_tpu_torch.parallel.launcher import launch_local

    verb_args = list(args.verb_args)
    if verb_args and verb_args[0] == "--":
        verb_args = verb_args[1:]
    if not verb_args:
        _out("launch: no verb given (e.g. launch -n 2 train -v engine.json)")
        return 2
    if verb_args[0] not in ("train", "eval", "batchpredict"):
        # without --distributed gating, N processes of any other verb would
        # just run N independent copies against shared storage
        _out(f"launch: only the train/eval/batchpredict verbs join a "
             f"distributed job (got {verb_args[0]!r})")
        return 2
    if "--distributed" not in verb_args:
        verb_args.append("--distributed")
    result = launch_local(
        verb_args,
        num_processes=args.num_processes,
        coordinator_port=args.coordinator_port,
        cpu_devices_per_process=args.cpu_devices_per_process,
        timeout=args.timeout,
    )
    if result.timed_out:
        _out(f"launch: timed out after {args.timeout}s; job killed "
             "(per-process logs below show which peer wedged)")
    for pid, (rc, out) in enumerate(zip(result.returncodes, result.outputs)):
        _out(f"--- process {pid} (exit {rc}) ---")
        if out:
            _out(out.rstrip())
    return 0 if result.ok else 1


def cmd_dist_status(args, storage: Storage) -> int:
    """``dist status`` (reference cli.py:1145): the operator view of a
    training mesh: generation, the members' heartbeat ages, the last
    coordinated commit and the quorum verdict. Exits 1 when the mesh is
    degraded, 2 when no coordination directory is given."""
    import json

    from incubator_predictionio_tpu_torch.distributed.context import DistConfig
    from incubator_predictionio_tpu_torch.distributed.meshdir import MeshDirectory

    conf = DistConfig.from_env()
    state_dir = getattr(args, "state_dir", None) or conf.state_dir
    if not state_dir:
        _err("dist status: no coordination dir (--state-dir or "
             "PIO_DIST_STATE_DIR)")
        return 2
    snap = MeshDirectory(state_dir).health_snapshot(
        conf.heartbeat_ms, quorum=conf.quorum or None)
    if getattr(args, "json", False):
        _out(json.dumps(snap, indent=2))
        return 1 if snap["degraded"] else 0
    _out(f"Mesh {state_dir}")
    _out(f"  generation: {snap['generation']}   members: "
         f"{snap['aliveMembers']}/{snap['expectedMembers']} alive   "
         f"quorum: {snap['quorum']}   "
         f"{'DEGRADED' if snap['degraded'] else 'ok'}")
    commit = snap.get("lastCommit")
    if commit:
        _out(f"  last commit: step {commit['step']} "
             f"(generation {commit['generation']})")
    else:
        _out("  last commit: none")
    for mrec in snap["members"]:
        state = "alive" if mrec["alive"] else (
            "fenced" if mrec["generation"] != snap["generation"] else "STALE")
        _out(f"  member {mrec['rank']}: pid {mrec['pid']} gen "
             f"{mrec['generation']} step {mrec['step']} "
             f"beat {mrec['ageMs']:.0f}ms ago [{state}]")
    return 1 if snap["degraded"] else 0


def cmd_status(args, storage: Storage) -> int:
    """(commands/Management.scala:99-181; reference cli.py:650): the
    version, the devices, each card's memory and the kernel builds' and
    first dispatches' wall times. Like the reference's backend start, it
    opens a context on every visible card, so that each gets a memory row."""
    import torch

    import incubator_predictionio_tpu_torch as port
    from incubator_predictionio_tpu_torch.utils.tracing import (
        device_memory_report,
    )

    _out(f"incubator_predictionio_tpu_torch {port.__version__}")
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        for d in range(n):
            torch.zeros(1, device=f"cuda:{d}")
        _out(f"Devices: {n} × gpu ({torch.cuda.get_device_name(0)})")
    else:
        _out("Devices: 1 × cpu (cpu)")
    for row in device_memory_report():
        if row["bytes_in_use"] is not None:
            _out(f"  {row['device']}: {row['bytes_in_use'] / 2**20:.1f} MiB in use"
                 + (f" / {row['bytes_limit'] / 2**20:.0f} MiB"
                    if row["bytes_limit"] else ""))
    _print_jit_status()
    _out("Your system is all ready to go.")
    return 0


def _print_jit_status() -> None:
    """The compile section of ``status`` (reference cli.py:683): wall time
    per executable name, the kernels' nvcc builds and the first dispatches
    of each serving shape (utils/jitstats.py), as seen in this process."""
    from incubator_predictionio_tpu_torch.utils import jitstats

    top = jitstats.top_compiles()
    if not top:
        return
    total = jitstats.compile_seconds_total()
    _out(f"JIT compiles: {total:.2f}s first-dispatch wall across "
         f"{jitstats.count()} cached key(s)")
    for name, sec, n in top:
        _out(f"  {name}: {sec:.3f}s over {n} compile(s)")


def _fetch_metrics_text(url: str, timeout: float = 10.0,
                        exemplars: bool = False) -> str:
    """GET one /metrics page. The pretty-printer asks for exemplars
    explicitly (``?exemplars=1``); ``--raw`` output stays strict 0.0.4."""
    import urllib.request

    if exemplars:
        url = f"{url}{'&' if '?' in url else '?'}exemplars=1"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def _metrics_url(url: str) -> str:
    url = url.rstrip("/")
    return url if url.endswith("/metrics") else url + "/metrics"


def _hist_by_labelset(samples) -> dict:
    """Histogram samples → {labelset_key: {"buckets": [(le, cum)],
    "sum": x, "count": n}}."""
    by_key: dict[tuple, dict] = {}
    for sname, labels, value in samples:
        key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
        slot = by_key.setdefault(key, {"buckets": [], "sum": 0.0,
                                       "count": 0.0})
        if sname.endswith("_bucket"):
            slot["buckets"].append((float(labels["le"]), value))
        elif sname.endswith("_sum"):
            slot["sum"] = value
        elif sname.endswith("_count"):
            slot["count"] = value
    return by_key


def _label_str(key: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key) or "(no labels)"


def _number(v):
    """A sample value as an int when it is a whole number."""
    return int(v) if float(v).is_integer() else v


def _render_metrics_single(families, args) -> None:
    from incubator_predictionio_tpu_torch.obs.metrics import bucket_quantiles

    for name in sorted(families):
        fam = families[name]
        kind, samples = fam["type"] or "untyped", fam["samples"]
        if args.filter and args.filter not in name:
            continue
        _out(f"{name} ({kind})" + (f" — {fam['help']}" if fam["help"] else ""))
        if kind == "histogram":
            ex_by_key: dict[tuple, list] = {}
            for sname, labels, ex in fam.get("exemplars", []):
                k = tuple(sorted((lk, lv) for lk, lv in labels.items()
                                 if lk != "le"))
                ex_by_key.setdefault(k, []).append((labels.get("le", "?"),
                                                    ex))
            # per label-set: count, sum, mean, estimated quantiles
            for key, slot in sorted(_hist_by_labelset(samples).items()):
                count = slot.get("count", 0)
                mean = (slot.get("sum", 0.0) / count) if count else 0.0
                qs = bucket_quantiles(slot["buckets"])
                _out(f"  {_label_str(key)}: count={int(count)} "
                     f"mean={mean * 1e3:.3f}ms "
                     + " ".join(f"~{k}={v * 1e3:.3f}ms"
                                for k, v in qs.items()))
                for le, ex in ex_by_key.get(key, []):
                    # the bucket's exemplar names the request's trace
                    # (GET /traces.json?traceId=<id>)
                    tid = ex.get("labels", {}).get("trace_id", "?")
                    _out(f"    exemplar le={le}: "
                         f"{ex['value'] * 1e3:.3f}ms trace={tid}")
        else:
            for sname, labels, value in sorted(
                    samples, key=lambda s: sorted(s[1].items())):
                label = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                _out(f"  {label or '(no labels)'}: {_number(value)}")


def _render_metrics_fleet(pages: dict, args) -> None:
    """Several servers' pages merged (reference cli.py:1597): one row a
    sample with a column a server and an aggregate (sum for counters and
    histogram count/sum, max for gauges; histogram quantiles re-estimated
    from the bucket-merged distribution)."""
    from incubator_predictionio_tpu_torch.obs.metrics import bucket_quantiles

    urls = list(pages)
    aliases = {url: f"s{i + 1}" for i, url in enumerate(urls)}
    _out("servers:")
    for url in urls:
        _out(f"  {aliases[url]} = {url}")
    names = sorted({n for fams in pages.values() for n in fams})
    for name in names:
        if args.filter and args.filter not in name:
            continue
        kinds = [pages[u][name]["type"] for u in urls
                 if name in pages[u] and pages[u][name]["type"]]
        kind = kinds[0] if kinds else "untyped"
        helps = [pages[u][name]["help"] for u in urls
                 if name in pages[u] and pages[u][name]["help"]]
        _out(f"{name} ({kind})" + (f" — {helps[0]}" if helps else ""))
        if kind == "histogram":
            per_server = {u: _hist_by_labelset(pages[u][name]["samples"])
                          for u in urls if name in pages[u]}
            keys = sorted({k for slots in per_server.values() for k in slots})
            for key in keys:
                cols = []
                merged_buckets: dict[float, float] = {}
                total_count = total_sum = 0.0
                for url in urls:
                    slot = per_server.get(url, {}).get(key)
                    if slot is None:
                        cols.append(f"{aliases[url]}=-")
                        continue
                    count = slot.get("count", 0)
                    p99 = bucket_quantiles(slot["buckets"],
                                           qs=(0.99,))["p99"]
                    cols.append(f"{aliases[url]} count={int(count)} "
                                f"~p99={p99 * 1e3:.3f}ms")
                    total_count += count
                    total_sum += slot.get("sum", 0.0)
                    for le, cum in slot["buckets"]:
                        merged_buckets[le] = merged_buckets.get(le, 0) + cum
                p99_all = bucket_quantiles(sorted(merged_buckets.items()),
                                           qs=(0.99,))["p99"]
                mean = (total_sum / total_count) if total_count else 0.0
                cols.append(f"all count={int(total_count)} "
                            f"mean={mean * 1e3:.3f}ms "
                            f"~p99={p99_all * 1e3:.3f}ms")
                _out(f"  {_label_str(key)}: " + " | ".join(cols))
        else:
            # counters sum across servers; gauges take the max (a depth or
            # a limit summed across servers is not a meaningful number)
            agg = max if kind == "gauge" else sum
            keys = sorted({tuple(sorted(labels.items()))
                           for u in urls if name in pages[u]
                           for _, labels, _ in pages[u][name]["samples"]})
            for key in keys:
                cols, values = [], []
                for url in urls:
                    vals = [
                        v for _, labels, v
                        in pages.get(url, {}).get(name, {}).get("samples", [])
                        if tuple(sorted(labels.items())) == key]
                    if not vals:
                        cols.append(f"{aliases[url]}=-")
                        continue
                    values.append(vals[0])
                    cols.append(f"{aliases[url]}={_number(vals[0])}")
                label = "max" if kind == "gauge" else "sum"
                cols.append(f"{label}={_number(agg(values) if values else 0)}")
                _out(f"  {_label_str(key)}: " + " ".join(cols))


def cmd_metrics(args, storage: Storage) -> int:
    """Fetch and pretty-print one or more servers' ``/metrics`` pages
    (reference cli.py:1683). Several URLs render a merged table with a
    column a server and a summed/max aggregate; the fetches run
    concurrently, so one dead server costs one timeout."""
    from concurrent.futures import ThreadPoolExecutor

    from incubator_predictionio_tpu_torch.obs.metrics import (
        MetricError,
        parse_prometheus_text,
    )

    urls = [_metrics_url(u) for u in args.urls]
    texts: dict[str, str] = {}
    failures: list[str] = []
    with ThreadPoolExecutor(max_workers=min(16, len(urls))) as pool:
        futures = {url: pool.submit(_fetch_metrics_text, url, args.timeout,
                                    not args.raw)
                   for url in urls}
        for url, fut in futures.items():
            try:
                texts[url] = fut.result()
            except Exception as e:  # noqa: BLE001 - a dead server is a row
                failures.append(f"{url}: {e}")
    for f in failures:
        _err(f"Unable to fetch {f}")
    if not texts:
        return 1
    if args.raw:
        for url, text in texts.items():
            if len(texts) > 1:
                _out(f"# ---- {url} ----")
            _out(text.rstrip())
        return 1 if failures else 0
    pages: dict[str, dict] = {}
    for url, text in texts.items():
        try:
            pages[url] = parse_prometheus_text(text)
        except MetricError as e:
            _err(f"{url} served malformed metrics: {e}")
            failures.append(url)
    if not pages:
        return 1
    if len(pages) == 1:
        _render_metrics_single(next(iter(pages.values())), args)
    else:
        _render_metrics_fleet(pages, args)
    return 1 if failures else 0


def _fetch_json(url: str, timeout: float = 10.0) -> dict:
    """GET one JSON document."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def cmd_profile(args, storage: Storage) -> int:
    """Fetch and render a server's ``GET /profile.json`` (reference
    cli.py:1742): per-scope phase attribution (where the time goes), the
    wall-stack sampler's top-N (when ``PIO_PROFILE_HZ`` > 0), training MFU
    and device-memory watermarks."""
    url = args.url.rstrip("/") + "/profile.json"
    try:
        doc = _fetch_json(url, args.timeout)
    except Exception as e:  # noqa: BLE001 - a dead server is the answer
        _err(f"Unable to fetch {url}: {e}")
        return 1
    if args.json:
        _out(json.dumps(doc, indent=2))
        return 0
    _out(f"service: {doc.get('service', '?')}")
    phases = doc.get("phases") or {}
    if not phases:
        _out("phases: none recorded yet")
    for scope in sorted(phases):
        e = phases[scope]
        wall = e.get("wall_seconds", 0.0)
        _out(f"{scope}: wall {wall:.3f}s over {e.get('count', 0)} scope(s)")
        for p, ph in sorted((e.get("phases") or {}).items(),
                            key=lambda kv: -kv[1]["seconds"]):
            pct = 100.0 * ph["seconds"] / wall if wall else 0.0
            _out(f"  {p:<12} {ph['seconds']:9.3f}s  {pct:5.1f}%  "
                 f"({ph['count']} interval(s))")
    tr = doc.get("training") or {}
    if tr.get("mfu"):
        peak = tr.get("peak_flops")
        _out(f"training MFU: {tr['mfu'] * 100:.1f}%"
             + (f" of {peak:.3g} FLOP/s peak" if peak else ""))
    for dev, v in sorted((doc.get("deviceWatermark") or {}).items()):
        _out(f"device {dev}: peak {v / 2**20:.1f} MiB")
    sampler = doc.get("sampler")
    if sampler is None:
        _out("sampler: off (set PIO_PROFILE_HZ to enable the wall-stack "
             "profiler)")
        return 0
    _out(f"sampler: {sampler['hz']:g} Hz, {sampler['samples']} sample(s)")
    for i, row in enumerate(sampler.get("top") or [], 1):
        stack = row.get("stack") or ["?"]
        _out(f"  #{i:<3}{row['pct']:5.1f}%  ({row['samples']})  {stack[0]}")
        for frame in stack[1:]:
            _out(f"          {frame}")
    return 0


def _fmt_bytes(n) -> str:
    if n is None:
        return "unbounded"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"  # pragma: no cover - loop always returns


def format_shard_stats(models) -> list[str]:
    """Human-readable shard layout for a deployed engine's models
    (reference cli.py:1257), separate from :func:`cmd_shards` so tests
    drive it with hand-built models."""
    from incubator_predictionio_tpu_torch.sharding.table import ShardSpec

    lines: list[str] = []
    for i, m in enumerate(models):
        name = type(m).__name__
        if not hasattr(m, "shard_info"):
            lines.append(f"model {i} ({name}): no shard layout "
                         "(not an embedding-table model)")
            continue
        info = m.shard_info()
        if not info.get("sharded"):
            lines.append(f"model {i} ({name}): UNSHARDED single-host layout")
            items = info.get("items") or {}
            lines.append(
                f"  items: {items.get('n_rows', '?')} rows × "
                f"{items.get('width', '?')} "
                f"({_fmt_bytes(items.get('table_bytes'))} f32; "
                f"train+adam {_fmt_bytes(items.get('train_bytes_per_shard'))}"
                "/chip)")
            budget = info.get("hbm_budget")
            lines.append(
                f"  hbm budget: {_fmt_bytes(budget)}"
                + ("  — EXCEEDS one chip: train/serve sharded "
                   "(PIO_SHARD_SERVE, docs/sharding.md)"
                   if info.get("requires_sharding") else ""))
            continue
        items, users = info["items"], info["users"]
        lines.append(
            f"model {i} ({name}): SHARDED ×{info['n_shards']} "
            f"({info['mode']} shards)")
        for label, t in (("items", items), ("users", users)):
            rows = t["shard_rows"]
            lines.append(
                f"  {label}: {t['n_rows']} rows → {t['rows_per_shard']}"
                f"/shard (real min/max {min(rows)}/{max(rows)}), "
                f"{_fmt_bytes(t['table_bytes'] // t['n_shards'])} f32/shard, "
                f"train+adam {_fmt_bytes(t['train_bytes_per_shard'])}/shard")
        spec = ShardSpec(items["name"], items["n_rows"], items["width"],
                         items["n_shards"])
        lines.append("  item row ranges: " + "  ".join(
            f"{s}:[{lo},{hi})" for s, (lo, hi) in
            ((s, spec.shard_bounds(s)) for s in range(spec.n_shards))))
        lines.append(
            f"  merge fan-in: {info['merge_fanin']} candidates/query "
            f"({info['n_shards']} shards × per-shard top-k, "
            f"serve_k {info['serve_k']})")
        budget = info.get("hbm_budget")
        if budget is not None:
            lines.append(f"  hbm budget: {_fmt_bytes(budget)}")
        ivf = info.get("ivf")
        if ivf and any(ivf):
            parts = [s["n_partitions"] for s in ivf if s]
            lines.append(
                f"  per-shard IVF: {sum(parts)} partitions total "
                f"({min(parts)}–{max(parts)}/shard) — each shard prunes "
                "locally, the merge reranks")
            if info.get("quantized"):
                lines.append(
                    f"  quantization: int8 rerank/shard "
                    f"({_fmt_bytes(items.get('shard_serve_bytes_int8'))} "
                    f"int8 vs "
                    f"{_fmt_bytes(items.get('table_bytes', 0) // max(info.get('n_shards', 1), 1))}"
                    f" f32 HBM/shard; saves "
                    f"{_fmt_bytes(info.get('rerank_bytes_saved', 0))} total)")
    return lines


def cmd_shards(args, storage: Storage) -> int:
    """Inspect the shard layout of the latest COMPLETED instance's models:
    per-shard row counts, HBM-bytes estimates, merge fan-in (reference
    cli.py:1331)."""
    from incubator_predictionio_tpu_torch.parallel.mesh import DeviceContext
    from incubator_predictionio_tpu_torch.server.query_server import (
        ServerConfig,
        load_deployed_engine,
    )

    # warmup=False: inspection only reads shard_info()
    deployed = load_deployed_engine(
        ServerConfig(engine_variant=args.engine_variant, max_batch=1),
        storage, DeviceContext.create(args.device), warmup=False)
    _out(f"engine instance {deployed.instance.id}")
    for line in format_shard_stats(deployed.models):
        _out(line)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pio-tpu",
        description="PredictionIO-capability ML server framework "
                    "(PyTorch/CUDA port: app new, import, train, eval, "
                    "deploy, undeploy, stream, batchpredict, launch, dist "
                    "status, shards)",
    )
    sub = parser.add_subparsers(dest="command")

    app = sub.add_parser("app").add_subparsers(dest="app_command")
    p = app.add_parser("new")
    p.add_argument("name")
    p.add_argument("--id", type=int, default=0)
    p.add_argument("--description")
    p.add_argument("--access-key", default="")

    p = sub.add_parser("train")
    p.add_argument("-v", "--engine-variant", default="engine.json")
    p.add_argument("--batch", default="")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--skip-sanity-check", action="store_true")
    p.add_argument("--stop-after-read", action="store_true")
    p.add_argument("--stop-after-prepare", action="store_true")
    p.add_argument("--device", help="torch device to train on (default: "
                                    "the card, cuda:0; 'cpu' for the CPU)")
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed job (see the launch verb / "
                        "PIO_DIST_* env)")
    p.add_argument("--mesh-axes", help='JSON mesh axes over the launched '
                   'processes, e.g. \'{"data": 2, "model": 2}\' (default: '
                   'every process on the data axis)')
    p.add_argument("--profile-dir",
                   help="capture a torch.profiler trace of the training "
                        "run into this directory (TensorBoard's PyTorch "
                        "profiler layout)")

    # launch (Runner.runOnSpark counterpart: N coordinated local processes)
    p = sub.add_parser("launch")
    p.add_argument("-n", "--num-processes", type=int, required=True)
    p.add_argument("--coordinator-port", type=int)
    p.add_argument("--cpu-devices-per-process", type=int,
                   help="1 runs the processes on the CPU (one device a "
                        "process; other values raise)")
    p.add_argument("--timeout", type=float, default=None,
                   help="kill the whole job after this many seconds (a wedged "
                        "peer otherwise hangs the launcher indefinitely)")
    p.add_argument("verb_args", nargs=argparse.REMAINDER,
                   help="the verb (and flags) each process runs")

    p = sub.add_parser("eval")
    p.add_argument("evaluation_class")
    p.add_argument("engine_params_generator_class", nargs="?")
    p.add_argument("-v", "--engine-variant", default="engine.json")
    p.add_argument("--batch", default="")
    p.add_argument("--device", help="torch device to evaluate on (default: "
                                    "the card, cuda:0; 'cpu' for the CPU)")
    p.add_argument("--no-fast-eval", action="store_true",
                   help="disable prefix memoization across variants "
                        "(FastEvalEngine is the default)")
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed job (see the launch verb / "
                        "PIO_DIST_* env); process 0 writes the instance")
    p.add_argument("--mesh-axes", help='JSON mesh axes over the launched '
                   'processes, e.g. \'{"data": 2, "model": 2}\' (default: '
                   'every process on the data axis)')

    p = sub.add_parser("deploy")
    p.add_argument("-v", "--engine-variant", default="engine.json")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--server-access-key",
                   help="guards /reload, /rollback, /stop and /delta")
    p.add_argument("--device", help="torch device to serve on (default: "
                                    "the card, cuda:0; 'cpu' for the CPU)")
    p.add_argument("--query-timeout", type=float, dest="query_timeout_sec",
                   help="total per-query budget in seconds; blown budgets "
                        "answer degraded-200 from the last-good cache "
                        "instead of 500, queries that expire while queued "
                        "answer 504 (docs/resilience.md)")
    p.add_argument("--algo-deadline", type=float, dest="algo_deadline_sec",
                   help="per-algorithm deadline in seconds; slower answers "
                        "count as circuit-breaker failures")
    p.add_argument("--algo-breaker-threshold", type=int, default=3,
                   help="consecutive failures before an algorithm's "
                        "breaker opens (default 3)")
    p.add_argument("--algo-breaker-reset", type=float, default=10.0,
                   dest="algo_breaker_reset_sec",
                   help="seconds an open algorithm breaker waits before a "
                        "half-open probe (default 10)")
    p.add_argument("--smoke-query", action="append",
                   help="JSON query payload the /reload and /delta gate "
                        "runs against a NEW engine before it may serve "
                        "(repeatable; any failure keeps the live one)")
    p.add_argument("--reload-probation", type=float, default=30.0,
                   dest="reload_probation_sec",
                   help="seconds after a swap during which a serving-"
                        "breaker trip rolls back to the previous instance "
                        "(default 30; 0 disables)")
    p.add_argument("--admission-max-queue", type=int,
                   help="bounded admission queue depth; waiting queries "
                        "beyond it answer 429 + Retry-After "
                        "(PIO_ADMISSION_MAX_QUEUE env, default 256)")
    p.add_argument("--admission-target-ms", type=float,
                   help="explicit latency target (ms) for the adaptive "
                        "concurrency limiter; unset = gradient mode "
                        "(PIO_ADMISSION_TARGET_MS env)")
    p.add_argument("--no-adaptive-admission", action="store_true",
                   help="disable the AIMD concurrency limiter "
                        "(PIO_ADMISSION_ADAPTIVE=0 env)")

    p = sub.add_parser("undeploy")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--server-access-key")

    # stream: incremental model updates from the live event feed
    p = sub.add_parser(
        "stream",
        help="streaming incremental updates: tail the eventlog change "
             "feed, fold events into embedding-row deltas, ship them to "
             "replicas as exactly-once delta deploys")
    p.add_argument("-v", "--engine-variant", default="engine.json")
    p.add_argument("--app", default="recommendation",
                   help="app whose eventlog to tail")
    p.add_argument("--channel", help="channel name (default: none)")
    p.add_argument("--state-dir", required=True,
                   help="cursor + trainer state + delta archive + dead "
                        "letters (crash-safe; single-writer)")
    p.add_argument("--feed-path",
                   help="explicit .piolog path (default: resolved from "
                        "the configured eventlog backend and --app)")
    p.add_argument("--replica", action="append",
                   help="query-server base URL to ship deltas to "
                        "(repeatable)")
    p.add_argument("--server-access-key",
                   help="the replicas' --server-access-key (guards "
                        "POST /delta)")
    p.add_argument("--batch-events", type=int, default=512,
                   help="max events folded per delta")
    p.add_argument("--interval", type=float, default=1.0,
                   help="seconds between idle polls")
    p.add_argument("--once", action="store_true",
                   help="one poll→fold→ship→commit round, then exit")
    p.add_argument("--max-batches", type=int,
                   help="exit after this many applied deltas")
    p.add_argument("--from-start", action="store_true",
                   help="start a fresh cursor at the BEGINNING of the log "
                        "instead of its current end (fold history too)")
    p.add_argument("--status", action="store_true",
                   help="print stream state (cursor, quarantine, dead "
                        "letters) and exit; non-zero when quarantined")
    p.add_argument("--dead-letter", action="store_true",
                   help="print dead-lettered poison events as JSON lines")
    p.add_argument("--device", help="torch device to fold on (default: "
                                    "the card, cuda:0; 'cpu' for the CPU)")
    p.add_argument("--obs-port", type=int, default=0,
                   help="serve /metrics, /traces.json and /profile.json on "
                        "this port from a background thread (the updater "
                        "has no HTTP surface of its own; 0 = off)")
    p.add_argument("--obs-ip", default="127.0.0.1",
                   help="bind address for --obs-port (default loopback)")

    p = sub.add_parser("batchpredict")
    p.add_argument("--input", default="batchpredict-input.json")
    p.add_argument("--output", default="batchpredict-output.json")
    p.add_argument("-v", "--engine-variant", default="engine.json")
    p.add_argument("--query-partitions", type=int)
    p.add_argument("--device", help="torch device to score on (default: "
                                    "the card, cuda:0; 'cpu' for the CPU)")
    p.add_argument("--distributed", action="store_true",
                   help="score a per-process slice under `launch -n N`; "
                        "writes <output>.part-<pid> files (the reference's "
                        "saveAsTextFile layout)")
    p.add_argument("--mesh-axes", help='JSON mesh axes over the launched '
                   'processes, e.g. \'{"data": 2, "model": 2}\' (default: '
                   'every process on the data axis)')

    p = sub.add_parser("import")
    p.add_argument("--appid", type=int, required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--channel")

    # shards: the sharded embedding layout (reference :3533-3539)
    p = sub.add_parser(
        "shards",
        help="inspect the sharded embedding layout of the latest trained "
             "model: per-shard row counts, HBM-bytes estimates, merge "
             "fan-in")
    p.add_argument("-v", "--engine-variant", default="engine.json")
    p.add_argument("--device", help="torch device to load the model on "
                                    "(default: the card, cuda:0; 'cpu' for "
                                    "the CPU)")

    # dist: the training mesh's coordination directory (reference :3604)
    dist = sub.add_parser(
        "dist",
        help="distributed training tier: status (mesh generation, member "
             "heartbeats, last coordinated checkpoint commit, quorum "
             "verdict)")
    ds = dist.add_subparsers(dest="dist_command")
    p = ds.add_parser("status")
    p.add_argument("--state-dir",
                   help="coordination directory (default: "
                        "PIO_DIST_STATE_DIR)")
    p.add_argument("--json", action="store_true")

    sub.add_parser("status")

    # metrics: scrape and pretty-print servers' /metrics (reference :3401)
    p = sub.add_parser(
        "metrics",
        help="fetch and pretty-print one or more servers' Prometheus "
             "/metrics pages (several URLs merge into a table with a "
             "column a server and a summed/max aggregate)")
    p.add_argument("urls", nargs="+",
                   help="server base URL(s), e.g. http://127.0.0.1:8000")
    p.add_argument("--raw", action="store_true",
                   help="print the raw exposition text instead")
    p.add_argument("--filter", help="only families whose name contains this")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="per-server fetch timeout in seconds (default 10)")

    # profile: the continuous profiler's live document (reference :3419)
    p = sub.add_parser(
        "profile",
        help="fetch and render a server's /profile.json: phase attribution, "
             "wall-stack sampler top-N (PIO_PROFILE_HZ), training MFU, "
             "device-memory watermarks")
    p.add_argument("url", help="server base URL, e.g. http://127.0.0.1:8000")
    p.add_argument("--timeout", type=float, default=10.0)
    p.add_argument("--json", action="store_true")
    return parser


_COMMANDS = {"train": cmd_train, "eval": cmd_eval, "deploy": cmd_deploy,
             "undeploy": cmd_undeploy, "stream": cmd_stream,
             "batchpredict": cmd_batchpredict, "import": cmd_import,
             "launch": cmd_launch, "shards": cmd_shards,
             "status": cmd_status, "metrics": cmd_metrics,
             "profile": cmd_profile}
_APP_COMMANDS = {"new": cmd_app_new}
_DIST_COMMANDS = {"status": cmd_dist_status}


def main(argv: Optional[list[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.command:
        parser.print_help()
        return 1
    # the engine directory is the import path of the variant's
    # engineFactory, as in the reference console
    if os.getcwd() not in sys.path and "" not in sys.path:
        sys.path.insert(0, os.getcwd())
    logging.basicConfig(
        level=logging.DEBUG if getattr(args, "verbose", False) else logging.INFO,
        format="[%(levelname)s] [%(name)s] %(message)s",
    )
    storage = get_storage()
    if args.command == "app":
        if not args.app_command:
            _err("app: missing subcommand (new)")
            return 1
        return _APP_COMMANDS[args.app_command](args, storage)
    if args.command == "dist":
        if not args.dist_command:
            _err("dist: missing subcommand (status)")
            return 1
        return _DIST_COMMANDS[args.dist_command](args, storage)
    return _COMMANDS[args.command](args, storage)


if __name__ == "__main__":
    sys.exit(main())
