"""Carry data between the reference package and the port.

The reference's arrays come in as anything ``numpy.asarray`` reads (its
dataclasses and NamedTuples can be passed as they are: fields are read by
name).  They become the port's tensors, with the port's pinned types, on a
given device; ``to_numpy`` goes back.  Both sides then run on identical
data.

``lm_params_from_jax`` carries the reference's LM parameter tree (any
config: dense, MoE, MLA, recurrent with its tail, or Whisper's
encoder-decoder) into a ``models.transformer.LM``;
``train_state_from_jax`` a whole TrainState (parameters, AdamW's step, μ
and ν, the compression residuals) into the port's, and
``train_state_to_jax`` back into the reference's tree of numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.algorithms.adsorption import AdsorptionState
from repro_torch.algorithms.kmeans import KMState
from repro_torch.algorithms.pagerank import PRState
from repro_torch.core.delta import DeltaBuffer
from repro_torch.core.partition import PartitionSnapshot
from repro_torch.data.graphs import CSRGraph
from repro_torch.device import resolve_device
from repro_torch.models.transformer import LM, stacked_name, stacked_row

# Field -> pinned dtype, per port type.
DTYPES = {
    CSRGraph: {"indptr": torch.int32, "indices": torch.int32,
               "out_degree": torch.int32},
    DeltaBuffer: {"keys": torch.int32, "payload": torch.float32,
                  "ann": torch.int8, "count": torch.int32,
                  "overflowed": torch.bool},
    PRState: {"acc": torch.float32, "sent": torch.float32},
    AdsorptionState: {"acc": torch.float32, "sent": torch.float32,
                      "seed": torch.float32},
    KMState: {"assign": torch.int32, "sums": torch.float32,
              "counts": torch.float32},
}


def _field(src, name: str):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def to_torch(cls, src, device=None):
    """Build a ``cls`` (a key of ``DTYPES``) from ``src``'s
    same-named fields (an object or a dict), pinned types, on ``device``."""
    dev = resolve_device(device)
    fields = {name: torch.from_numpy(np.array(_field(src, name))).to(
        device=dev, dtype=dtype) for name, dtype in DTYPES[cls].items()}
    return cls(**fields)


def to_numpy(obj) -> dict:
    """One of the port's ``DTYPES`` types as a dict of numpy arrays, by
    field name."""
    names = (obj._fields if hasattr(obj, "_fields")
             else [f.name for f in dataclasses.fields(obj)])
    return {n: getattr(obj, n).detach().cpu().numpy() for n in names}


def snapshot(src) -> PartitionSnapshot:
    """A port PartitionSnapshot with ``src``'s n_keys, num_shards, scheme
    and replication."""
    return PartitionSnapshot(
        **{n: _field(src, n) for n in
           ("n_keys", "num_shards", "scheme", "replication")})


def snapshot_fields(snap: PartitionSnapshot) -> dict:
    """Back: the snapshot's fields as a dict."""
    return dataclasses.asdict(snap)


def _array_to_torch(arr) -> torch.Tensor:
    """A CPU tensor of ``arr`` (anything ``numpy.asarray`` reads).  A
    bfloat16 array (ml_dtypes' type, which ``torch.from_numpy`` refuses)
    is carried by its bits, recognised by dtype name."""
    arr = np.array(arr)          # a contiguous, writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def lm_params_from_jax(cfg, params, device=None) -> LM:
    """An ``LM`` on ``device`` holding the reference's parameters
    ``params`` (its ``transformer.init_params`` tree; the unit's arrays
    are stacked under ``units/b{i}_<kind>`` with a leading unit axis, a
    tail layer's under ``tail/t{j}_<kind>`` unstacked
    (``transformer.layer_leaf``): for MoE the float32 router, the experts
    and arctic's ``ffn.dense``; for MLA ``attn.{w_dq, w_uq, w_dkv, w_uk,
    w_uv, w_kr, wo}`` and the float32 ``attn.{q_norm, kv_norm}``; for the
    recurrent kinds ``cell``'s weights (RG-LRU's float32 ``conv_w``,
    ``w_a``, ``w_x``, ``lam``; mLSTM's float32 ``w_if``; sLSTM's float32
    ``r_gates``); for Whisper each decoder block's ``ln_cross`` and
    ``cross.{wq, wk, wv, wo}``, and the encoder's blocks stacked under
    ``enc_units/b0_enc`` beside ``enc_norm``), bit for bit.  Names, shapes
    and types must match exactly, and every leaf of the tree is filled."""
    model = LM(cfg, resolve_device(device))

    def put(dst, src, name):
        t = _array_to_torch(src)
        if t.shape != dst.shape or t.dtype != dst.dtype:
            raise ValueError(f"{name}: reference has {t.dtype}"
                             f"{tuple(t.shape)}, port {dst.dtype}"
                             f"{tuple(dst.shape)}")
        dst.copy_(t)

    def leaf(tree, name):
        for part in name.split("."):
            tree = tree[part]
        return tree

    n_leaves = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            src = leaf(params, stacked_name(name, model))
            u = stacked_row(name, model)
            if u is not None:
                put(p, np.asarray(src)[u], name)
                n_leaves += u == 0
            else:
                put(p, src, name)
                n_leaves += 1
    want = sum(len(_leaves(params[k])) for k in params)
    if n_leaves != want:
        raise ValueError(f"the reference tree has {want} leaves, the port "
                         f"filled {n_leaves}")
    return model


def train_state_from_jax(cfg, state, device=None):
    """The port's ``train_step.TrainState`` holding the reference's
    ``state`` (its ``TrainState``, or anything with the same fields): the
    parameters through :func:`lm_params_from_jax`, asking for gradients;
    μ, ν and the residuals as float32 tensors of the stacked leaves, by
    leaf name; the step as int32."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState, unnest
    dev = resolve_device(device)
    params = lm_params_from_jax(cfg, _field(state, "params"), dev)
    params.requires_grad_(True)

    def leaves(tree):
        return {name: _array_to_torch(x).to(dev)
                for name, x in unnest(tree).items()}

    opt = _field(state, "opt")
    res = _field(state, "residuals")
    return TrainState(
        params=params,
        opt=AdamWState(step=_array_to_torch(_field(opt, "step")).to(
            device=dev, dtype=torch.int32),
            mu=leaves(_field(opt, "mu")), nu=leaves(_field(opt, "nu"))),
        residuals=None if res is None else leaves(res))


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy; bfloat16 (which numpy lacks) as its 2-byte bits,
    dtype 'V2', which ``.view(ml_dtypes.bfloat16)`` reads."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def train_state_to_jax(state):
    """The port's TrainState as the reference's tree: the same NamedTuple
    fields (``params``, ``opt.step``, ``opt.mu``, ``opt.nu``,
    ``residuals``), each a nested dict of numpy arrays with the stacked
    leaves' shapes (bfloat16 as its bits, see :func:`_tensor_to_numpy`)."""
    from repro_torch.train.train_step import checkpoint_tree

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return _tensor_to_numpy(tree)

    tree = checkpoint_tree(state)
    return type(tree)(
        params=host(tree.params),
        opt=type(tree.opt)(step=_tensor_to_numpy(tree.opt.step),
                           mu=host(tree.opt.mu), nu=host(tree.opt.nu)),
        residuals=None if tree.residuals is None else host(tree.residuals))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]
