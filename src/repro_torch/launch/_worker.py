"""Worker process entry point for the multi-process launch path.

Run as ``python -m repro_torch.launch._worker --id K --root DIR ...`` by
``launch/distributed.py``'s :class:`Cluster` (long-lived protocol
workers) and :func:`selftest` (oneshot process-group bring-up).

IMPORT DISCIPLINE: this module imports ONLY the standard library and
``launch/channel.py`` (the ``repro_torch`` package itself loads nothing).
torch is imported lazily, in the modes that need it, so a protocol-only
worker (``--torch off``) starts in a fraction of a second and a
replacement process is spawned without paying for torch.  Keep it that
way.

Modes (``--torch``):

  * ``off``: the lease and ack protocol only;
  * ``local``: every ack carries a real computation on the worker's
    device (``--device``, ``cuda`` by default: raises without CUDA; the
    tests pass ``cpu``), initialised before the first heartbeat;
  * ``distributed``: join a ``torch.distributed`` process group
    (``launch/mesh.py`` ``init_shard_group`` over
    ``tcp://--coordinator``, NCCL unless ``--backend gloo``), build the
    flat mesh of ``--num-shards`` shards over it, all-gather the process
    ids once, and report rank, world, device and the rank's shards.

The worker's life:

  * write a ``ready.json`` report + first heartbeat (the lease uptake);
  * loop: renew the lease every ``--hb-interval``; follow ``cmd.json``
    (shard assignment, shutdown); ack each broadcast stratum task;
  * exit when orphaned (the coordinator died) or told to shut down.

A SIGKILL simply stops the loop: heartbeats cease and the coordinator's
lease table notices; a SIGSTOP freezes it: heartbeats arrive late, the
straggle signal.  Nothing here cooperates with its own failure.
"""
from __future__ import annotations

import os
import time
from typing import List

from repro_torch.launch.channel import (ack_path, read_json, stratum_path,
                                        worker_dir, write_heartbeat,
                                        write_json)

TORCH_MODES = ("off", "local", "distributed")


def _report_distributed(args) -> dict:
    """Distributed-mode bring-up: join the process group, build the flat
    mesh, run one all_gather of the process ids, report ownership."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import (flat_mesh, init_shard_group,
                                         local_shards)
    init_shard_group(args.backend, f"tcp://{args.coordinator}",
                     world_size=args.num_processes, rank=args.process_id)
    try:
        mesh = flat_mesh(args.num_shards, device=args.device)
        gathered = mesh.all_gather(torch.tensor(
            [args.process_id], dtype=torch.int32, device=mesh.device))
        return {
            "process_index": mesh.rank,
            "num_processes": mesh.world,
            "backend": dist.get_backend(),
            "device": str(mesh.device),
            "num_shards": mesh.num_shards,
            "local_shards": list(local_shards(mesh)),
            "allgather": gathered.cpu().tolist(),
        }
    finally:
        dist.destroy_process_group()


def _device_work(seq: int, device) -> float:
    """A real computation on the worker's device per stratum ack
    (``local``/``distributed`` modes): proves the worker's runtime is
    alive, not just its event loop."""
    import torch
    return float(torch.sum(torch.arange(256, dtype=torch.float32,
                                        device=device) + seq))


def worker_main(args) -> int:
    root = args.root
    wid = args.id
    os.makedirs(worker_dir(root, wid), exist_ok=True)
    report = {"worker_id": wid, "torch": args.torch, "pid": os.getpid()}
    device = None
    if args.torch == "distributed":
        report.update(_report_distributed(args))
        device = report["device"]
    elif args.torch == "local":
        from repro_torch.device import resolve_device
        device = resolve_device(args.device)    # raises without CUDA
        _device_work(0, device)                 # runtime (and CUDA) up
        report["device"] = str(device)
    write_json(os.path.join(worker_dir(root, wid), "ready.json"), report)
    write_heartbeat(root, wid, 0, torch=args.torch)
    if args.oneshot:
        return 0

    ppid = os.getppid()
    shards: List[int] = []
    hb_seq, last_hb = 1, time.monotonic()
    last_ack_seq = -1
    cmd_seq = -1
    poll_s = max(min(args.hb_interval / 4.0, 0.02), 0.001)
    while True:
        now = time.monotonic()
        if os.getppid() != ppid:          # coordinator gone: orphan exit
            return 1
        try:
            cmd = read_json(os.path.join(worker_dir(root, wid),
                                         "cmd.json"))
        except (OSError, ValueError):
            cmd = None
        if cmd and cmd.get("seq", -1) > cmd_seq:
            cmd_seq = cmd["seq"]
            if cmd.get("kind") == "shutdown":
                return 0
            if cmd.get("kind") == "assign":
                shards = list(cmd.get("shards", []))
        if now - last_hb >= args.hb_interval:
            write_heartbeat(root, wid, hb_seq, tuple(shards),
                            torch=args.torch)
            hb_seq += 1
            last_hb = now
        try:
            task = read_json(stratum_path(root))
        except (OSError, ValueError):
            task = None
        if task and task.get("seq", -1) > last_ack_seq:
            last_ack_seq = task["seq"]
            ack = {"worker_id": wid, "seq": last_ack_seq,
                   "stratum": task.get("stratum", -1),
                   "t": time.monotonic()}
            if device is not None:
                ack["device_work"] = _device_work(last_ack_seq, device)
            write_json(ack_path(root, wid, last_ack_seq), ack)
        time.sleep(poll_s)


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        description="Launch-path worker process (heartbeat/lease/ack "
                    "loop, optional per-worker torch runtime).")
    parser.add_argument("--id", type=int, required=True)
    parser.add_argument("--root", required=True)
    parser.add_argument("--hb-interval", type=float, default=0.1)
    parser.add_argument("--torch", default="off", choices=TORCH_MODES)
    parser.add_argument("--device", default=None,
                        help="local/distributed modes: the torch device "
                             "(default: cuda; raises without it)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="distributed mode: the process group's "
                             "backend (default: nccl)")
    parser.add_argument("--oneshot", action="store_true")
    parser.add_argument("--coordinator", default="")
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=0)
    parser.add_argument("--num-shards", type=int, default=None,
                        help="distributed mode: shards of the flat mesh "
                             "(default: one a process)")
    args = parser.parse_args(argv)
    if args.num_shards is None:
        args.num_shards = args.num_processes
    return worker_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
