"""``pio-tpu`` console of the port, cut to the train → eval → deploy path.

Counterpart of ``incubator_predictionio_tpu/tools/cli.py`` (reference
tools/console/Console.scala): the verbs ``app new``, ``import``, ``train``,
``eval``, ``deploy`` and ``launch``, with the reference's argument names (its
cli.py:58, :231, :267, :295, :631, :3786). ``train``, ``eval`` and
``deploy`` run on the card unless ``--device cpu`` asks for the CPU.
``launch -n N train …`` runs N coordinated ``train --distributed``
processes (``parallel/launcher.py``). The other verbs come with ROADMAP.md
Queue 1, items 6 and 7. Run it as ``python -m
incubator_predictionio_tpu_torch.tools.cli <verb>``; :func:`main` takes the
arguments, so a caller can run a verb in-process.
"""

from __future__ import annotations

import argparse
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
    )
    instance_id = create_workflow(config, storage)
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
    )
    instance_id = create_workflow(config, storage)
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
    )
    serve_forever(config, storage, DeviceContext.create(args.device))
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
    if verb_args[0] != "train":
        raise NotImplementedError(
            f"launch {verb_args[0]}: sharded evaluation and batch prediction "
            "come with the sharding slice of the PyTorch port (ROADMAP.md "
            "Queue 1, item 4)")
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pio-tpu",
        description="PredictionIO-capability ML server framework "
                    "(PyTorch/CUDA port: app new, import, train, eval, "
                    "deploy, launch)",
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
                   help="join a torch.distributed job (comes with the "
                        "sharding slice: raises)")

    p = sub.add_parser("deploy")
    p.add_argument("-v", "--engine-variant", default="engine.json")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--server-access-key")
    p.add_argument("--device", help="torch device to serve on (default: "
                                    "the card, cuda:0; 'cpu' for the CPU)")

    p = sub.add_parser("import")
    p.add_argument("--appid", type=int, required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--channel")
    return parser


_COMMANDS = {"train": cmd_train, "eval": cmd_eval, "deploy": cmd_deploy,
             "import": cmd_import, "launch": cmd_launch}
_APP_COMMANDS = {"new": cmd_app_new}


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
    return _COMMANDS[args.command](args, storage)


if __name__ == "__main__":
    sys.exit(main())
