"""Training driver: the train loop with checkpoints and resume, on one
device or sharded over a mesh (the reference's ``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 50 [--reduced] [--compression delta] [--resume]

The loop checkpoints every ``--ckpt-every`` steps through the port's
``CheckpointManager`` (the reference's file format and tree paths) and
``--resume`` restores the latest snapshot.  Parameters are random, from
``--seed`` (``train_step.init_train_state``); batches come from the
synthetic ``TokenPipeline``, one per step, so a resumed run sees the
batches the uninterrupted one saw.  The schedule is the reference's: a
warm-up of 10 steps, then a cosine to 0.1 ``--lr`` at ``--steps``.
``--device`` defaults to CUDA; ``--device cpu --reduced`` runs a tiny
config on the CPU.

``--mesh DxM``: where a process group is initialised (one rank a
process, ``launch/mesh.init_shard_group``; D·M ranks), the state is
stored on a ("data", "model") ``DeviceMesh`` by ``launch/sharding.py``'s
specs and every step is the sharded one (``train/train_step.py``,
parameters gathered a layer at a time); every rank draws the same batches
and takes its rows.  The model axis splits storage, not compute: each of
its ranks computes every layer whole on the same rows, so it brings no
speedup (tensor parallelism is not ported).  A checkpoint holds the
whole tensors (every rank gathers them, rank 0 writes), so its files are
the one-device run's; a resume cuts them back to each rank's blocks.
Without a group ``--mesh 1x1`` is the one-device loop and any other mesh
raises; launched by ``torchrun`` (``WORLD_SIZE`` set), ``main`` forms the
group from the environment (gloo for ``--device cpu``, else NCCL).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.configs import get_arch
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, TrainState,
                                          checkpoint_tree, init_train_state,
                                          make_train_step, restore_tree,
                                          shard_train_state)

WARMUP_STEPS = 10


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    start_step: int          # 0, or the step a resume restored
    losses: list             # float, one a step run
    metrics: list            # {name: float}, one a step run
    walls: list              # seconds a step, host clock after a sync


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_mesh(mesh: str, device: torch.device):
    """The ("data", "model") mesh that ``--mesh DxM`` names, over the
    initialised process group; None for 1x1 without one (the one-device
    loop).  Raises where D·M ranks are needed and no group is there."""
    import torch.distributed as dist
    d, m = (int(x) for x in mesh.split("x"))
    if (d, m) == (1, 1) and not (dist.is_available()
                                 and dist.is_initialized()):
        return None
    return make_mesh((d, m), ("data", "model"), device=device.type)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def train(cfg, steps: int, seq_len: int = 128, global_batch: int = 8,
          lr: float = 3e-3, microbatches: int = 1, compression: str = "none",
          ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
          resume: bool = False, host_id: int = 0, num_hosts: int = 1,
          mesh: str = "1x1", seed: int = 0, device=None,
          log: Callable = print) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps (from a restored step with
    ``resume``); ``mesh`` "DxM" (module docstring)."""
    dev = resolve_device(device)
    the_mesh = train_mesh(mesh, dev)
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=lr, warmup_steps=WARMUP_STEPS,
                          total_steps=steps),
        microbatches=microbatches, compression=compression)
    state = init_train_state(
        cfg, tcfg, torch.Generator(device=dev).manual_seed(seed), dev)
    if the_mesh is not None:
        state = shard_train_state(state, the_mesh)
    ckpt = None
    if resume or ckpt_every:
        ckpt = CheckpointManager(
            ckpt_dir or os.path.join(tempfile.gettempdir(),
                                     "repro_torch_ckpt"),
            num_nodes=num_hosts, replication=min(3, num_hosts))
    start_step = 0
    if resume:
        try:
            tree, start_step = ckpt.load_full(host_id,
                                              checkpoint_tree(state))
            state = restore_tree(state, tree)
            log(f"resumed from step {start_step}")
        except FileNotFoundError:
            log("no checkpoint found; starting fresh")
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq_len,
                         global_batch=global_batch, host_id=host_id,
                         num_hosts=num_hosts, seed=seed, device=dev)
    step_fn = make_train_step(cfg, tcfg)
    out = TrainResult(state, start_step, [], [], [])
    t_start = time.perf_counter()
    for step in range(start_step, steps):
        batch = pipe.batch_at(step)
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        _sync(dev)
        out.walls.append(time.perf_counter() - t0)
        vals = {k: float(v) for k, v in metrics.items()}
        out.metrics.append(vals)
        out.losses.append(vals["loss"])
        if step % 10 == 0 or step == steps - 1:
            log(f"step {step:5d} loss {vals['loss']:.4f} "
                f"gnorm {vals['grad_norm']:.3f} lr {vals['lr']:.2e} "
                f"wire {vals['wire_bytes']:.2e}B "
                f"({time.perf_counter() - t_start:.1f}s)")
        if ckpt_every and (step + 1) % ckpt_every == 0:
            tree = checkpoint_tree(state)
            if _rank() == 0:
                ckpt.save_full(host_id, step + 1, tree)
            del tree
            if the_mesh is not None:
                import torch.distributed as dist
                dist.barrier()
            log(f"checkpointed @ {step + 1}")
    out.state = state
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL, e.g. 2x2 (a process group of D*M "
                         "ranks, one a process); MODEL splits storage, "
                         "not compute: each model rank computes every "
                         "layer whole")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "delta"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_ckpt in the temp directory")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    group = args.mesh != "1x1" and "WORLD_SIZE" in os.environ
    if group:
        # One rank a process (torchrun): the group from the environment.
        from repro_torch.launch.mesh import init_shard_group
        init_shard_group("gloo" if args.device == "cpu" else None)
    try:
        train(cfg, args.steps, seq_len=args.seq_len,
              global_batch=args.global_batch, lr=args.lr,
              microbatches=args.microbatches, compression=args.compression,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              resume=args.resume, host_id=args.host_id,
              num_hosts=args.num_hosts, mesh=args.mesh, seed=args.seed,
              device=args.device)
    finally:
        if group:
            import torch.distributed as dist
            dist.destroy_process_group()
    print("done.")


if __name__ == "__main__":
    main()
