"""The dry run: every (arch x shape) cell traced on the production mesh
with fake tensors, and counted (the reference's ``launch/dryrun.py``).

  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out f.json]
      [--opt-level N] [--device cuda|cpu] [--mesh DxM]

For each cell this process initialises a ``fake`` process group of 256
ranks (512 with ``--multi-pod``) and a (16, 16) ``DeviceMesh`` over
("data", "model") ((2, 16, 16) with "pod"), makes it ambient and enters
``FakeTensorMode`` (:func:`fake_world`): tensors have shapes, dtypes and
devices and no storage, and collectives return at once.  It builds the
cell's program on the port's own functions (:func:`build_cell`): the state
stored by ``launch/sharding.py``'s specs (DTensors), each rank's block
allocated for rank 0, the batch or cache likewise; then runs the program
once under a counting mode (:class:`Count`) and writes the reference's
record (:func:`run_cell`), which ``launch/roofline.py`` reads unchanged.
``--device`` is the fake tensors' device: ``cuda`` (the default; it raises
without CUDA) traces the card's program, whose attention goes through the
flash kernels' custom ops (``kernels/flash_attention/ops.py``: their
fakes and FLOP formulas); ``cpu`` traces the CPU's, whose attention is the
plain ``ref.py``.

The counts are those of rank 0, the rank's own work on its local tensors:

* ``flops``: the FLOPs of each operator by ``torch.utils.flop_counter``'s
  formulas (matrix products, convolutions, attention; the flash ops'
  formulas count the tiles their kernels visit), summed.
* ``bytes_accessed``: the bytes of every input and output tensor of each
  operator that is not a view, summed.  This is an unfused count, each
  eager operator reading its inputs from memory and writing its outputs;
  the reference's is XLA's, after fusion, so it reads lower for the same
  program.
* ``collective_bytes``: by the reference's kinds and rule, each
  collective's result bytes (x 2 for an all-reduce), plus ``total``: the
  functional collectives of DTensor's redistributions (the ZeRO-3 gathers,
  their reduce-scatters in the backward) and the ``torch.distributed``
  calls of the sharded step, flash decoding and the a2a dispatch.  A
  collective moves no bytes on an axis of size 1: the port issues none
  there.
* ``memory``: ``argument_size_in_bytes``, the local bytes of the program's
  inputs (state, batch or cache: each rank's blocks by the specs);
  ``output_size_in_bytes``, the bytes of outputs that alias no input (the
  in-place updates of parameters, moments and caches count 0);
  ``temp_size_in_bytes``, the peak of live local storage during the
  program beyond the arguments (storages followed from their creation by
  an operator to their release; what a kernel allocates inside its own
  launch is not seen).

DTensor's operators are counted below DTensor, where they run on local
tensors: the counting mode passes an operator on DTensors on to DTensor,
whose local operators and collectives come back to it.  The operators that
DTensor's sharding propagation runs on global shapes to learn an output's
shape are not counted.

The programs (:func:`build_cell`), on the port's functions:

* train: ``make_train_step`` on a state stored by ``shard_train_state``
  (parameters, float32 μ and ν), the batch stored by ``batch_spec``
  (each rank's rows); the port's defaults (``use_flash_kernel=True``,
  one microbatch).
* prefill: ``prefill_forward`` (``encode`` first for Whisper, ``embeds``
  for qwen2-vl) on the stored parameters and batch.
* decode: ``decode_step`` on the stored parameters and a cache stored by
  ``cache_tree_specs``.  A cache leaf the step reads whole is gathered
  over the model axis for the step and its block written back; with
  ``flash_decode`` (level 2) a GQA cache's slots stay split.

Levels (``--opt-level``, the reference's 0 to 3).  The port's parameters
are stored sharded at every level and its layer code needs them gathered,
so every program gathers them a layer at a time (``make_gather_fn``,
inside the recomputation under remat), and AdamW updates them in place:
the reference's constrained outputs and donation (level 1) and ZeRO-3
gathering (level 2, passed as ``gather_fn``) add nothing, and levels 0, 1
and 2 compute the same train and prefill programs.  Level 2 adds flash
decoding to decode; level 3 takes ``moe_strategy="a2a"`` where the config
has experts.

The train and prefill programs compute over the model axis as
``sharding.tp_plan`` says (``models/tp.py``): rank 0's products are its
blocks of the split parts (heads, d_ff, vocab), so its counts shrink by
the model axis's size there and stay whole where a part is replicated,
and its collectives add the model axis's all-reduces (the row-parallel
sums, the column-parallel inputs' gradients, the vocab-parallel loss's
reductions).  Decode computes replicated over the model axis.

Departures from the reference's record:

* ``probes`` is ``[]``: the port keeps its layers unstacked and traces
  every one of them, so there is no scan body counted once to compose.
* The HLO parser (``collective_bytes(hlo_text)``) is not ported: there is
  no HLO, and the counting mode sees each collective as it is issued.
* Added keys: ``device`` (the fake tensors' device); ``tp``: each part of
  the plan on the mesh's model axis (``attention``, ``kv``, ``mlp``,
  ``head``), ``"split"`` or ``"replicated"`` (KV heads that each rank
  computes for its query heads read ``"replicated"``; a decode cell's
  parts all ``"replicated"``); ``moe_rows``:
  ``"capacity"`` for a config with experts, whose dispatch the trace
  counts with every expert's buffer full (``models/moe.py``: a fake tensor
  has no routes); ``inner_loops``: ``"one_trip"`` for xLSTM, whose
  trace counts one trip of each inner time loop (one mLSTM chunk, one
  sLSTM step), as XLA counts a while body once, and ``roofline.analyse``
  adds the other trips (``xlstm_correction``, as the reference's).
  Traced in full, xlstm-350m's sLSTM loop is 4,096 eager steps a layer at
  train_4k and 32,768 at prefill_32k.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import weakref
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES, ArchConfig, Shape, cells, get_arch
from repro_torch.launch import mesh as meshes
from repro_torch.launch import sharding
from repro_torch.models import transformer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


class Spec(NamedTuple):
    """The stand-in of an input: its shape and dtype."""
    shape: tuple
    dtype: torch.dtype


def _config(arch) -> ArchConfig:
    return arch if isinstance(arch, ArchConfig) else get_arch(arch)


def _shape(shape) -> Shape:
    return shape if isinstance(shape, Shape) else SHAPES[shape]


def input_specs(arch, shape_name) -> dict:
    """Spec stand-ins for every model input of a cell (the reference's
    shapes and dtypes); ``arch`` and ``shape_name`` are names or an
    ``ArchConfig`` and a ``Shape``."""
    cfg = _config(arch)
    shape = _shape(shape_name)
    b, t = shape.global_batch, shape.seq_len
    dt = _DTYPES[cfg.dtype]
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": Spec((b, t), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = Spec((b, t), torch.int32)
        if cfg.frontend == "audio_stub":
            batch["frames"] = Spec((b, cfg.encoder_seq, cfg.d_model), dt)
        elif cfg.frontend == "vision_stub":
            batch["embeds"] = Spec((b, t, cfg.d_model), dt)
        return batch
    return {"token": Spec((b, 1), torch.int32),
            "pos": Spec((), torch.int32)}


# ---------------------------------------------------------------------------
# The fake world.
# ---------------------------------------------------------------------------

def production_shape(multi_pod: bool = False) -> tuple:
    """(sizes, axis names) of the production mesh."""
    m = meshes.make_production_mesh(multi_pod=multi_pod)
    return m.sizes, m.axis_names


@contextlib.contextmanager
def fake_world(shape=(16, 16), axes=("data", "model"), device="cuda"):
    """A ``fake`` process group of prod(shape) ranks, this process rank 0,
    a ``DeviceMesh`` of ``shape`` over it (on ``device``) made ambient, and
    ``FakeTensorMode`` entered; yields (mesh, the fake mode).  Everything
    is torn down after.  Refuses a process whose default group is already
    initialised (the dry run takes a process of its own)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without an "
                           "initialised process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        mesh = meshes.make_mesh(shape, axes, device=device)
        meshes.dp_group(mesh)     # made outside FakeTensorMode, then kept
        with meshes.set_mesh(mesh), FakeTensorMode() as fake:
            yield mesh, fake
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Counting.
# ---------------------------------------------------------------------------

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")
# Operator (overload packet) name -> the reference's kind.  The c10d ops
# take their result tensors as their first argument.
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.send": "collective-permute",
}
_IN_PLACE_COLL = ("c10d.",)
# Operators that move no data of their own.
_SKIP = ("_c10d_functional.wait_tensor", "prim.device", "c10d.barrier")


def _tensor_leaves(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples and modules (a
    module's parameters and buffers), DTensors as their local blocks."""
    out = []

    def visit(x):
        if isinstance(x, torch.Tensor):
            with torch.no_grad():
                out.append(sharding.local(x))
        elif isinstance(x, nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                visit(t)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
    visit(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storages(tensors) -> dict:
    """{id: (storage, bytes)} of the tensors' storages, each once."""
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out.setdefault(id(st), (st, st.nbytes()))
    return out


def _flat_tensors(x) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


class Count(TorchDispatchMode):
    """Counts the operators run under it on local tensors (module
    docstring): ``flops``, ``bytes_accessed``, ``collective`` bytes by
    kind, and the peak of live storage (``peak`` bytes above ``held``, the
    bytes of the storages :meth:`hold` registered)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.formulas = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collective = {k: 0.0 for k in COLL_KINDS}
        self.live = 0
        self.peak = 0
        self.held = 0
        self._tracked: dict = {}
        self._propagating = 0

    def hold(self, tree) -> int:
        """Register the storages of ``tree``'s tensors as live (the
        program's arguments); returns their bytes."""
        n = 0
        for key, (st, size) in _storages(_tensor_leaves(tree)).items():
            if self._track(key, st, size):
                n += size
        self.held += n
        return n

    def _track(self, key, st, size) -> bool:
        if key in self._tracked:
            return False
        self._tracked[key] = size
        self.live += size
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)
        return True

    def _release(self, key) -> None:
        self.live -= self._tracked.pop(key, 0)

    @contextlib.contextmanager
    def _propagation_marked(self):
        """Marks the operators DTensor's sharding propagation runs on
        global shapes (its output-shape inference), which are not the
        rank's work."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        orig = getattr(SP, "_propagate_tensor_meta_non_cached", None)
        if orig is None:        # a torch without it: nothing to mark
            yield
            return

        def marked(prop, op_schema):
            self._propagating += 1
            try:
                return orig(prop, op_schema)
            finally:
                self._propagating -= 1
        SP._propagate_tensor_meta_non_cached = marked
        try:
            yield
        finally:
            SP._propagate_tensor_meta_non_cached = orig

    def __enter__(self):
        self._marks = self._propagation_marked()
        self._marks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._marks.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs it on local tensors
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        name = str(func.overloadpacket)
        if name.startswith(_SKIP):
            return out
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            result = args[0] if name.startswith(_IN_PLACE_COLL) else out
            size = sum(_nbytes(t) for t in _flat_tensors(result))
            self.collective[kind] += size * (2.0 if kind == "all-reduce"
                                             else 1.0)
        else:
            formula = self.formulas.get(func.overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            if not func.is_view:
                self.bytes_accessed += sum(
                    _nbytes(t) for t in _flat_tensors((args, kwargs, out)))
        for t in _flat_tensors(out):
            if not isinstance(t, DTensor):
                st = t.untyped_storage()
                self._track(id(st), st, st.nbytes())
        return out

    def collective_bytes(self) -> dict:
        out = dict(self.collective)
        out["total"] = sum(out.values())
        return out


def trace(fn, args: tuple) -> dict:
    """Run ``fn(*args)`` once under :class:`Count` -> {"flops",
    "bytes_accessed", "collective_bytes", "memory", "seconds", "out"}
    (module docstring)."""
    count = Count()
    held = count.hold(args)
    arg_ids = set(count._tracked)
    t0 = time.perf_counter()
    with count:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    new = {k: v for k, v in _storages(_tensor_leaves(out)).items()
           if k not in arg_ids}
    return {"flops": float(count.flops),
            "bytes_accessed": float(count.bytes_accessed),
            "collective_bytes": count.collective_bytes(),
            "memory": {"temp_size_in_bytes": int(count.peak - held),
                       "argument_size_in_bytes": int(held),
                       "output_size_in_bytes": int(sum(
                           size for _, size in new.values()))},
            "seconds": seconds, "out": out}


def argument_bytes(args: tuple) -> int:
    """The local bytes of a program's inputs, each storage once."""
    return int(sum(size for _, size in
                   _storages(_tensor_leaves(args)).values()))


# ---------------------------------------------------------------------------
# Cell programs.
# ---------------------------------------------------------------------------

def _empty(spec: Spec, device) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device=device)


def store_batch(batch: dict, mesh) -> dict:
    """Each array of a batch stored by ``batch_spec`` (each rank keeps its
    rows)."""
    return {k: sharding.distribute(v, mesh, sharding.placements(
        sharding.batch_spec(tuple(v.shape), mesh), mesh))
        for k, v in batch.items()}


def _rows(batch: dict, mesh) -> tuple[dict, bool]:
    """(this rank's rows of a stored batch, whether they are split over the
    data-parallel axes)."""
    spec = sharding.batch_spec(tuple(next(iter(batch.values())).shape), mesh)
    return {k: sharding.local(v) for k, v in batch.items()}, \
        spec[0] is not None


def _model_dim(mesh) -> int:
    return meshes.axis_names(mesh).index("model")


def _cache_in_use(mesh, flash: bool):
    """A stored cache leaf as the decode step takes it: with flash
    decoding a GQA cache's slots stay this rank's block; every other leaf
    is gathered over the model axis (the port's decode is not split
    there)."""
    from torch.distributed.tensor import Replicate, Shard
    md = _model_dim(mesh)

    def use(path, x):
        slot = next((d for key, d in sharding.SLOT_DIMS.items()
                     if path.endswith("/" + key)), None)
        place = list(x.placements)
        if flash and slot is not None:
            if meshes.model_axis_size(mesh) > 1 and place[md] != Shard(slot):
                raise ValueError(f"{path}: flash decoding splits the slots "
                                 f"(dim {slot}) over the model axis, but the "
                                 f"cache is stored as {place}")
            return x.to_local()
        place[md] = Replicate()
        if place == list(x.placements):
            return x.to_local()
        return x.redistribute(mesh, place).to_local()
    return use


def _write_back(mesh):
    """Copy this rank's block of an updated leaf into its stored DTensor
    (nothing where the step updated the stored block in place)."""
    md = _model_dim(mesh)

    def put(path, x, new):
        loc = x.to_local()
        if new.shape == loc.shape and \
                new.untyped_storage() is loc.untyped_storage():
            return x
        p = x.placements[md]
        if p.is_shard():
            n = meshes.model_axis_size(mesh)
            size = new.shape[p.dim] // n
            new = new.narrow(p.dim, mesh.get_local_rank("model") * size,
                             size)
        with torch.no_grad():
            loc.copy_(new)
        return x
    return put


def store_cache(cache: dict, mesh, cfg) -> dict:
    """Each leaf of a decode cache stored by ``cache_tree_specs`` (the
    reference's specs)."""
    specs = sharding.cache_tree_specs(cache, mesh, cfg)
    return sharding.walk(cache, lambda _, x, spec: sharding.distribute(
        x, mesh, sharding.placements(spec, mesh)), specs)


class Cell(NamedTuple):
    fn: object            # the program
    args: tuple           # its inputs, stored on the mesh
    kind: str             # "train" | "prefill" | "decode"


def build_cell(arch, shape_name, mesh, opt_level: int = 1, device="cuda",
               microbatches: int = 1) -> Cell:
    """The cell's program and its inputs on ``mesh``, under
    :func:`fake_world` (module docstring); ``arch`` and ``shape_name`` as
    :func:`input_specs` takes them, ``microbatches`` the train step's."""
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import (TrainConfig, TrainState,
                                              make_train_step,
                                              shard_train_state)
    cfg = _config(arch)
    shape = _shape(shape_name)
    dev = torch.device(device)
    a2a = opt_level >= 3 and cfg.n_experts
    tcfg = TrainConfig(
        microbatches=microbatches,
        gather_fn=sharding.make_gather_fn(mesh) if opt_level >= 2 else None,
        moe_strategy="a2a" if a2a else "sort")
    hook = tcfg.gather_fn or sharding.make_gather_fn(mesh)
    specs = input_specs(arch, shape_name)
    params = transformer.LM(cfg, dev)

    if shape.kind == "train":
        params.requires_grad_(True)
        state = shard_train_state(TrainState(params, adamw_init(params),
                                             None), mesh)
        batch = store_batch({k: _empty(s, dev) for k, s in specs.items()},
                            mesh)
        return Cell(make_train_step(cfg, tcfg), (state, batch), "train")

    sharding.shard_params(params, mesh)
    if shape.kind == "prefill":
        batch = store_batch({k: _empty(s, dev) for k, s in specs.items()},
                            mesh)

        def prefill_fn(params, batch):
            rows, split = _rows(batch, mesh)
            with torch.no_grad(), meshes.set_mesh(mesh, batch_split=split):
                kw = {}
                if "frames" in rows:
                    kw["enc_out"] = transformer.encode(
                        cfg, params, rows["frames"], gather_fn=hook)
                if "embeds" in rows:
                    kw["embeds"] = rows["embeds"]
                return transformer.prefill_forward(
                    cfg, params, rows["tokens"], shape.seq_len,
                    gather_fn=hook, moe_strategy=tcfg.moe_strategy, **kw)
        return Cell(prefill_fn, (params, batch), "prefill")

    flash = opt_level >= 2
    cache = store_cache(transformer.init_cache(
        cfg, shape.global_batch, shape.seq_len, dev), mesh, cfg)
    token = store_batch({"token": _empty(specs["token"], dev)},
                        mesh)["token"]
    pos = _empty(specs["pos"], dev)

    def decode_fn(params, cache, token, pos):
        use = sharding.walk(cache, _cache_in_use(mesh, flash))
        with torch.no_grad(), meshes.set_mesh(mesh):
            logits, new = transformer.decode_step(
                cfg, params, sharding.local(token), use, pos,
                flash_decode=flash, gather_fn=hook)
        sharding.walk(cache, _write_back(mesh), new)
        return logits, cache
    return Cell(decode_fn, (params, cache, token, pos), "decode")


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             verbose: bool = True, with_probes: bool = True,
             opt_level: int = 1, device="cuda", mesh_shape=None) -> dict:
    """Trace one cell in a fake world of the production mesh (or of a
    ("data", "model") mesh of ``mesh_shape``) and return the reference's
    record (module docstring); ``with_probes`` is accepted for the
    reference's signature (the port composes no probes)."""
    cfg = get_arch(arch)
    sizes, axes = production_shape(multi_pod)
    if mesh_shape is not None:
        sizes, axes = tuple(mesh_shape), ("data", "model")
    t0 = time.perf_counter()
    with fake_world(sizes, axes, device) as (mesh, _):
        cell = build_cell(arch, shape_name, mesh, opt_level, device)
        got = trace(cell.fn, cell.args)
        devices = mesh.size()
        del cell, got["out"]
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, sizes)),
        "opt_level": opt_level,
        "devices": int(devices),
        "compile_s": round(time.perf_counter() - t0, 2),
        "main_compile_s": round(got["seconds"], 2),
        "flops": got["flops"],
        "bytes_accessed": got["bytes_accessed"],
        "collective_bytes": got["collective_bytes"],
        "probes": [],
        "memory": got["memory"],
        "device": str(torch.device(device).type),
        # Decode computes replicated over the model axis.
        "tp": sharding.tp_plan(cfg, 1 if SHAPES[shape_name].kind == "decode"
                               else dict(zip(axes, sizes)).get("model", 1)
                               ).record(),
    }
    if cfg.n_experts:
        result["moe_rows"] = "capacity"
    if any(k in ("mlstm", "slstm") for k in cfg.unit):
        result["inner_loops"] = "one_trip"
    if verbose:
        print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--opt-level", type=int, default=0,
                    help="0-2: the same train and prefill programs; 2 adds "
                         "flash decoding, 3 the a2a MoE dispatch (module "
                         "docstring)")
    ap.add_argument("--out", default="")
    ap.add_argument("--mesh", default="",
                    help="DxM: a (\"data\", \"model\") mesh of that shape "
                         "in place of the production one")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (the card's "
                         "program; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "trace the CPU's program")

    mesh_shape = (tuple(int(n) for n in args.mesh.split("x"))
                  if args.mesh else None)
    if args.all:
        todo = [(a, s) for a, s, skip in cells() if not skip]
        # Cheap archs first so partial results are useful early.
        order = {"olmo-1b": 0, "xlstm-350m": 1, "starcoder2-3b": 2,
                 "qwen2-vl-2b": 3, "recurrentgemma-2b": 4, "llama3-8b": 5,
                 "whisper-large-v3": 6, "minicpm3-4b": 7,
                 "mixtral-8x22b": 8, "arctic-480b": 9}
        todo.sort(key=lambda c: (order.get(c[0], 99), c[1]))
    else:
        todo = [(args.arch, args.shape)]
    results = []
    for arch, shape in todo:
        try:
            results.append(run_cell(arch, shape, args.multi_pod,
                                    with_probes=not args.no_probes,
                                    opt_level=args.opt_level,
                                    device=args.device,
                                    mesh_shape=mesh_shape))
        except Exception as e:  # noqa: BLE001 — report, continue sweep
            print(json.dumps({"arch": arch, "shape": shape,
                              "error": repr(e)[:500]}), flush=True)
            results.append({"arch": arch, "shape": shape,
                            "error": repr(e)[:500]})
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    errs = [r for r in results if "error" in r]
    print(f"# {len(results) - len(errs)}/{len(results)} cells traced",
          file=sys.stderr)
    sys.exit(1 if errs else 0)


if __name__ == "__main__":
    main()
