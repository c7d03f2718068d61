"""ray-tpu CLI: start/join/status/submit/logs/jobs/down
(``ray_tpu/scripts/cli.py``).

Parity target: the reference's `ray` CLI
(reference: python/ray/scripts/scripts.py — start :654, status :1682,
`ray job submit` via python/ray/dashboard/modules/job/cli.py), trimmed to
the operations a GPU host deployment needs. Run as:

    python -m ray_tpu_torch.scripts.cli start --head [--port P] [--num-cpus N]
    python -m ray_tpu_torch.scripts.cli start --address HOST:PORT [--num-cpus N]
    python -m ray_tpu_torch.scripts.cli status --address HOST:PORT
    python -m ray_tpu_torch.scripts.cli submit --address HOST:PORT -- CMD...
    python -m ray_tpu_torch.scripts.cli jobs --address HOST:PORT
    python -m ray_tpu_torch.scripts.cli logs --address HOST:PORT JOB_ID
    python -m ray_tpu_torch.scripts.cli down --address HOST:PORT
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def _cmd_start(args) -> int:
    if args.head:
        # Foreground head + one node (the reference's `ray start --head`
        # daemonizes; staying foreground suits containers/systemd).
        from ray_tpu_torch.cluster.head import HeadServer
        from ray_tpu_torch.cluster.node_manager import NodeManager

        persist = args.persist or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch",
            f"head_state_{args.port or 0}.db")
        os.makedirs(os.path.dirname(persist), exist_ok=True)
        head = HeadServer("0.0.0.0" if args.public else "127.0.0.1",
                          args.port or 0, persist_path=persist)
        print(f"ray_tpu_torch head listening at {head.address}", flush=True)
        resources = {"CPU": float(args.num_cpus or (os.cpu_count() or 1))}
        if args.num_gpus:
            resources["GPU"] = float(args.num_gpus)
        node = NodeManager(head.address, _new_node_id(), resources, {},
                           args.object_store_memory)
        print(f"node {node.node_id[:12]} joined with {resources}",
              flush=True)
        print(f"Connect drivers with ray_tpu_torch.init(address="
              f"{head.address!r}) or RTPU_ADDRESS={head.address}",
              flush=True)
        return _block_forever(head, node)
    # Worker node joining an existing head.
    from ray_tpu_torch.cluster.node_manager import NodeManager

    resources = {"CPU": float(args.num_cpus or (os.cpu_count() or 1))}
    if args.num_gpus:
        resources["GPU"] = float(args.num_gpus)
    node = NodeManager(args.address, _new_node_id(), resources, {},
                       args.object_store_memory)
    print(f"node {node.node_id[:12]} joined {args.address} "
          f"with {resources}", flush=True)
    return _block_forever(None, node)


def _new_node_id() -> str:
    import uuid

    return uuid.uuid4().hex


def _block_forever(head, node) -> int:
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        if node is not None:
            node.shutdown()
        if head is not None:
            head.shutdown()
        return 0


def _connect(address: str):
    import ray_tpu_torch

    return ray_tpu_torch.init(address=address, ignore_reinit_error=True)


def _cmd_status(args) -> int:
    rt = _connect(args.address)
    total, avail = rt.head.retrying_call("cluster_resources", timeout=10)
    nodes = rt.head.retrying_call("list_nodes", timeout=10)
    demand = rt.head.retrying_call("get_demand", 30.0, timeout=10)
    print(f"Nodes: {len([n for n in nodes if n['alive']])} alive "
          f"/ {len(nodes)} total")
    for n in nodes:
        state = "ALIVE" if n["alive"] else "DEAD"
        print(f"  {n['node_id'][:12]} {state:5s} {n['address']:21s} "
              f"avail={n['available']} total={n['resources']}")
    print(f"Resources: total={total} available={avail}")
    if demand["unmet"]:
        print(f"Pending demand: {len(demand['unmet'])} unmet requests "
              f"(e.g. {demand['unmet'][0]})")
    return 0


def _cmd_submit(args) -> int:
    from ray_tpu_torch.jobs import JobSubmissionClient

    _connect(args.address)
    client = JobSubmissionClient()
    import shlex

    entrypoint = shlex.join(args.entrypoint)
    runtime_env = json.loads(args.runtime_env) if args.runtime_env else None
    job_id = client.submit_job(entrypoint=entrypoint,
                               runtime_env=runtime_env,
                               submission_id=args.submission_id)
    print(f"submitted {job_id}: {entrypoint!r}")
    if args.no_wait:
        return 0
    status = client.wait_until_finish(job_id, timeout=args.timeout)
    sys.stdout.write(client.get_job_logs(job_id))
    print(f"job {job_id} -> {status.value}")
    return 0 if status.value == "SUCCEEDED" else 1


def _cmd_jobs(args) -> int:
    from ray_tpu_torch.jobs import JobSubmissionClient

    _connect(args.address)
    for info in JobSubmissionClient().list_jobs():
        dur = (info.end_time or time.time()) - info.start_time
        print(f"{info.submission_id:28s} {info.status:9s} {dur:7.1f}s "
              f"{info.entrypoint!r}"
              + (f"  ({info.message})" if info.message else ""))
    return 0


def _cmd_logs(args) -> int:
    from ray_tpu_torch.jobs import JobSubmissionClient

    _connect(args.address)
    sys.stdout.write(JobSubmissionClient().get_job_logs(args.job_id))
    return 0


def _cmd_serve_deploy(args) -> int:
    import json as _json

    from ray_tpu_torch import serve

    _connect(args.address)
    handles = serve.deploy_config(args.config)
    print(_json.dumps({"deployed": sorted(handles),
                       "status": serve.status()}, indent=1, default=str))
    return 0


def _cmd_down(args) -> int:
    rt = _connect(args.address)
    nodes = rt.head.retrying_call("list_nodes", timeout=10)
    for n in nodes:
        try:
            rt.head.retrying_call("drain_node", n["node_id"], timeout=10)
        except Exception:
            pass
    print(f"drained {len(nodes)} node(s); head remains for re-attach")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ray-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="start a head or join a node")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", help="head address to join (node mode)")
    sp.add_argument("--port", type=int, default=None)
    sp.add_argument("--public", action="store_true",
                    help="bind 0.0.0.0 instead of loopback")
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--num-gpus", type=float, default=None)
    sp.add_argument("--object-store-memory", type=int, default=2 << 30)
    sp.add_argument("--persist", default=None,
                    help="head state sqlite path (head mode)")
    sp.set_defaults(fn=_cmd_start)

    for name, fn in (("status", _cmd_status), ("jobs", _cmd_jobs),
                     ("down", _cmd_down)):
        s2 = sub.add_parser(name)
        s2.add_argument("--address", required=True)
        s2.set_defaults(fn=fn)

    s3 = sub.add_parser("submit", help="run an entrypoint as a cluster job")
    s3.add_argument("--address", required=True)
    s3.add_argument("--runtime-env", default=None,
                    help='JSON, e.g. \'{"env_vars": {"K": "V"}}\'')
    s3.add_argument("--submission-id", default=None)
    s3.add_argument("--no-wait", action="store_true")
    s3.add_argument("--timeout", type=float, default=3600.0)
    s3.add_argument("entrypoint", nargs=argparse.REMAINDER)
    s3.set_defaults(fn=_cmd_submit)

    s4 = sub.add_parser("logs")
    s4.add_argument("--address", required=True)
    s4.add_argument("job_id")
    s4.set_defaults(fn=_cmd_logs)

    s5 = sub.add_parser(
        "serve-deploy",
        help="deploy serve applications from a YAML config "
             "(reference: `serve deploy`)")
    s5.add_argument("--address", required=True)
    s5.add_argument("config", help="path to the serve YAML")
    s5.set_defaults(fn=_cmd_serve_deploy)

    args = p.parse_args(argv)
    if args.cmd == "start" and not args.head and not args.address:
        p.error("start requires --head or --address")
    if args.cmd == "submit":
        args.entrypoint = [a for a in args.entrypoint if a != "--"]
        if not args.entrypoint:
            p.error("submit requires an entrypoint after --")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
