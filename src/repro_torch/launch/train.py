"""Training driver: the train loop with checkpoints and resume, on one
device (the reference's ``launch/train.py``).

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
config on the CPU.  Only ``--mesh 1x1``: a data or model axis needs
``launch/sharding.py`` (ROADMAP queue 1, slice 9h).
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
from repro_torch.models.attention import _not_ported
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (SHARDING_SLICE, TrainConfig,
                                          TrainState, checkpoint_tree,
                                          init_train_state, make_train_step,
                                          restore_tree)

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


def check_mesh(mesh: str) -> None:
    d, m = (int(x) for x in mesh.split("x"))
    if (d, m) != (1, 1):
        raise _not_ported(f"--mesh {mesh} (a sharded train step)",
                          SHARDING_SLICE)


def train(cfg, steps: int, seq_len: int = 128, global_batch: int = 8,
          lr: float = 3e-3, microbatches: int = 1, compression: str = "none",
          ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
          resume: bool = False, host_id: int = 0, num_hosts: int = 1,
          mesh: str = "1x1", seed: int = 0, device=None,
          log: Callable = print) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps (from a restored step with
    ``resume``)."""
    check_mesh(mesh)
    dev = resolve_device(device)
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=lr, warmup_steps=WARMUP_STEPS,
                          total_steps=steps),
        microbatches=microbatches, compression=compression)
    state = init_train_state(
        cfg, tcfg, torch.Generator(device=dev).manual_seed(seed), dev)
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
            ckpt.save_full(host_id, step + 1, checkpoint_tree(state))
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
                    help="DATAxMODEL; only 1x1 is ported")
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
    train(cfg, args.steps, seq_len=args.seq_len,
          global_batch=args.global_batch, lr=args.lr,
          microbatches=args.microbatches, compression=args.compression,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          resume=args.resume, host_id=args.host_id,
          num_hosts=args.num_hosts, mesh=args.mesh, seed=args.seed,
          device=args.device)
    print("done.")


if __name__ == "__main__":
    main()
