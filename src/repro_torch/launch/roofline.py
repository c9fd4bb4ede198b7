"""Roofline analysis over the dry-run cells (the reference's
``launch/roofline.py``), with the H100's constants.

Per (arch x shape) cell, from the compiled program's per-device counts:

    compute term    = FLOPs a device      / the card's dense bf16 FLOP/s
    memory term     = bytes a device      / the card's HBM B/s
    collective term = collective bytes    / the card's NVLink B/s

MODEL_FLOPS (the useful-work yardstick):
    train   : 6·N·D       (dense)  or 6·N_active·D  (MoE)   [+attention]
    prefill : 2·N·D + attention
    decode  : 2·N·B (one token per sequence) + attention-over-cache

The xlstm cells carry an analytic correction for the inner time scans
(``xlstm_correction``: a compiler that counts a loop body once misses the
sLSTM/mLSTM chunk loops' trips).

The card's constants come from NVIDIA's H100 datasheet, by the name
``torch.cuda.get_device_name()`` reports (SXM5 and PCIe differ): dense
bf16 989.4 TFLOP/s, HBM3 3.35 TB/s and NVLink 900 GB/s for SXM5; 756
TFLOP/s, HBM2e 2.0 TB/s and the NVLink bridge's 600 GB/s for PCIe.  The
NVLink figures are both directions together (18 links of 50 GB/s on
SXM5; 450 GB/s each way).  A card not in :data:`CARDS` raises.
"""
from __future__ import annotations

import argparse
import json
from typing import NamedTuple, Optional, Union

from repro_torch.configs import SHAPES, get_arch


class Chip(NamedTuple):
    name: str
    peak_flops: float      # dense bf16 FLOP/s
    hbm_bw: float          # B/s
    link_bw: float         # NVLink B/s, both directions together


CARDS = {
    "h100-sxm5": Chip("h100-sxm5", 989.4e12, 3.35e12, 900e9),
    "h100-pcie": Chip("h100-pcie", 756e12, 2.0e12, 600e9),
}


def chip_constants(card: Union[str, Chip, None] = None) -> Chip:
    """The constants of ``card``: a :class:`Chip` as it is; a card name as
    ``torch.cuda.get_device_name()`` gives it ("NVIDIA H100 80GB HBM3" is
    SXM5, a name with "PCIe" the PCIe card) or a key of :data:`CARDS`;
    None = the name of CUDA device 0."""
    if isinstance(card, Chip):
        return card
    if card is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: name the card "
                               f"(one of {sorted(CARDS)})")
        card = torch.cuda.get_device_name(0)
    if card in CARDS:
        return CARDS[card]
    if "H100" in card and "PCIe" in card:
        return CARDS["h100-pcie"]
    if "H100" in card and ("HBM3" in card or "SXM" in card):
        return CARDS["h100-sxm5"]
    raise ValueError(f"no datasheet constants for the card {card!r}; "
                     f"known: {sorted(CARDS)}")


def model_params(cfg) -> tuple[float, float]:
    """(total_params, active_params) — active counts top-k experts only."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    mlp = 3 * d * ff
    per_kind = {
        "dense": attn + mlp, "enc": attn + mlp,
        "attn_local": attn + mlp,
        "dec_cross": 2 * attn + mlp,
        "mla": (d * cfg.mla_q_rank + cfg.mla_q_rank * h * (hd + cfg.mla_rope_dim)
                + d * cfg.mla_kv_rank + 2 * cfg.mla_kv_rank * h * hd
                + d * cfg.mla_rope_dim + h * hd * d + mlp),
        "moe": (attn + cfg.n_experts * mlp
                + (mlp if cfg.moe_dense_residual else 0) + d * cfg.n_experts),
        "mlstm": 3 * d * h * hd + d * 2 * h + d * h * hd + h * hd * d,
        "slstm": d * 4 * h * hd + 4 * h * hd * hd + h * hd * d,
        "rec": (2 * d * cfg.rnn_dim + 2 * cfg.rnn_dim ** 2
                + cfg.rnn_dim * d + mlp),
    }
    total = active = 0.0
    seq = list(cfg.unit) * cfg.n_units + list(cfg.tail)
    for kind in seq:
        total += per_kind[kind]
        if kind == "moe":
            active += (attn + cfg.top_k * mlp
                       + (mlp if cfg.moe_dense_residual else 0)
                       + d * cfg.n_experts)
        else:
            active += per_kind[kind]
    enc = cfg.encoder_layers * per_kind["enc"] if cfg.encoder_layers else 0
    total += enc
    active += enc
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    return total + emb, active + emb


def step_flops(cfg, kind: str, b: int, t: int) -> float:
    """Analytic useful FLOPs of one step of ``kind`` ("train", "prefill"
    or "decode") over batch ``b`` at sequence (or cache) length ``t``."""
    _, active = model_params(cfg)
    d = cfg.d_model
    n_attn = sum(k in ("dense", "moe", "attn_local", "mla", "enc",
                       "dec_cross")
                 for k in list(cfg.unit) * cfg.n_units + list(cfg.tail))
    if kind == "train":
        toks = b * t
        eff_t = min(t, cfg.window) if cfg.window else t
        attn_fl = 3 * 2 * 2 * b * t * eff_t * d * n_attn / 2  # fwd+bwd, causal/2
        return 6.0 * active * toks + attn_fl
    if kind == "prefill":
        toks = b * t
        eff_t = min(t, cfg.window) if cfg.window else t
        attn_fl = 2 * 2 * b * t * eff_t * d * n_attn / 2
        return 2.0 * active * toks + attn_fl
    # decode: one token/sequence; attention reads the whole cache
    eff_s = min(t, cfg.window) if cfg.window else t
    attn_fl = 2 * 2 * b * 1 * eff_s * d * n_attn
    return 2.0 * active * b + attn_fl


def model_flops(arch: str, shape_name: str) -> float:
    """Analytic useful FLOPs (global) for the cell."""
    shape = SHAPES[shape_name]
    return step_flops(get_arch(arch), shape.kind, shape.global_batch,
                      shape.seq_len)


def xlstm_correction(arch: str, shape_name: str) -> float:
    """Extra FLOPs hidden in the xLSTM inner time scans (bodies counted
    once; static trip counts known).  Global FLOPs."""
    if arch != "xlstm-350m":
        return 0.0
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        return 0.0                  # decode has no inner scan
    b, t = shape.global_batch, shape.seq_len
    h, hd, ch = cfg.n_heads, cfg.hd, cfg.mlstm_chunk
    n_units = cfg.n_units
    # mLSTM chunk body: intra scores 2·b·ch²·h·hd ×2 (qk, pv) + carry
    # einsums ≈ 2·b·ch·h·hd² ×3; trips = t/ch (body counted once).
    trips_m = t // ch
    body_m = b * (4 * ch * ch * h * hd + 6 * ch * h * hd * hd)
    # sLSTM step: recurrent gates 2·4·h·hd² per token; trips = t.
    body_s = b * 8 * h * hd * hd
    mult = 3.0 if shape.kind == "train" else 1.0   # fwd+bwd(2×) vs fwd
    return mult * n_units * ((trips_m - 1) * body_m + (t - 1) * body_s)


def analyse(cell: dict, chip: Union[str, Chip, None] = None
            ) -> Optional[dict]:
    """The roofline row of a dry-run cell on ``chip``
    (:func:`chip_constants`)."""
    if "error" in cell:
        return None
    c = chip_constants(chip)
    chips = cell["devices"]
    flops_dev = cell["flops"] + xlstm_correction(
        cell["arch"], cell["shape"]) / chips
    bytes_dev = cell["bytes_accessed"]
    coll_dev = cell["collective_bytes"]["total"]
    t_compute = flops_dev / c.peak_flops
    t_memory = bytes_dev / c.hbm_bw
    t_coll = coll_dev / c.link_bw
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cell["arch"], cell["shape"])
    useful = mf / (flops_dev * chips) if flops_dev > 0 else 0.0
    bound = max(t_compute, t_memory, t_coll)
    # Roofline fraction: useful work over what the dominant term allows.
    step_time = bound
    mfu = mf / (chips * c.peak_flops * step_time) if step_time > 0 else 0.0
    return {
        "arch": cell["arch"], "shape": cell["shape"], "chips": chips,
        "compute_s": t_compute, "memory_s": t_memory,
        "collective_s": t_coll, "dominant": dominant,
        "model_flops": mf, "hlo_flops_global": flops_dev * chips,
        "useful_ratio": useful, "roofline_mfu": mfu,
    }


def what_would_help(row: dict) -> str:
    d = row["dominant"]
    if d == "collective":
        return ("shrink/overlap collectives: pre-aggregate before "
                "all-reduce, avoid KV re-gather, 2D-shard so gathers move "
                "shards not replicas")
    if d == "memory":
        return ("raise arithmetic intensity: fuse attention (flash), "
                "larger tiles, bf16 residuals, avoid materializing "
                "logits/scores")
    return ("compute-bound (good): push MFU via MXU-aligned tiles, "
            "remat policy tuning, overlap the residual collectives")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("results", help="the dry run's cells (JSON list)")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--card", default=None,
                    help="card name or key of CARDS (default: CUDA "
                         "device 0's name)")
    args = ap.parse_args(argv)
    chip = chip_constants(args.card)
    with open(args.results) as f:
        cells = json.load(f)
    rows = [r for r in (analyse(c, chip) for c in cells) if r]
    if args.markdown:
        print("| arch | shape | compute s | memory s | collective s | "
              "dominant | MODEL/HLO | roofline MFU |")
        print("|---|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} "
                  f"| {r['memory_s']:.4f} | {r['collective_s']:.4f} "
                  f"| **{r['dominant']}** | {r['useful_ratio']:.2f} "
                  f"| {r['roofline_mfu']:.3f} |")
    else:
        for r in rows:
            r["hint"] = what_would_help(r)
            print(json.dumps(r))


if __name__ == "__main__":
    main()
