"""Roofline analysis over the dry-run records (the reference's
``launch/roofline.py``), against the published peaks of an NVIDIA H100
80GB HBM3 (SXM) at a 700 W power limit (NVIDIA's data sheet).

Per (arch x shape x mesh) cell:
    compute    = flops            / peak_flops[compute dtype]   [s]
    memory     = bytes_accessed   / HBM_bw                      [s]
    collective = collective_bytes / link_bw                     [s]

All quantities are per device (``launch/dryrun.py``).

Departures from the reference:
  * no scan correction: the reference adds (L-1) x layer_probe because
    XLA's ``cost_analysis()`` counts a scanned layer body once; the port's
    layers are a Python loop and its count already holds every layer, so
    ``analyze`` adds nothing (``layer_probe`` stays in the record, for the
    per-layer split and as a check);
  * a peak per compute dtype: 989e12 FLOP/s for bf16 work on the tensor
    cores, 67e12 for float32 (the port sets no ``allow_tf32``, so float32
    products run outside the tensor cores) and for the search arch's
    int32 work; the reference has one peak (197e12, its TPU's bf16);
  * links: NVLink at 450e9 B/s each way; a mesh of more than 8 cards
    crosses hosts, whose links are not modeled;
  * ``bytes_accessed`` is the unfused eager traffic, op by op, where the
    reference's is XLA's after fusion;
  * a peak memory the dry run could not reckon (null) prints as null.

MODEL_FLOPS = 6*N*T (train), 2*N*T (prefill/serve fwd), with N_active for
MoE: the utilization yardstick, :func:`model_flops_per_device` copied
from the reference as it is.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int32": 67e12}
HBM_BW = 3.35e12
LINK_BW = 450e9


def model_flops_per_device(rec: dict, archs) -> float:
    """Analytic useful flops per device for the cell."""
    arch = archs[rec["arch"]]
    n_dev = rec["n_devices"]
    kind = rec["kind"]
    meta = rec.get("meta", {})
    if arch.family == "lm":
        n_active = meta.get("active_params", meta.get("model_params", 0))
        tokens = meta.get("tokens", 0)
        mult = 6 if kind == "train" else 2
        return mult * n_active * tokens / n_dev
    if arch.family == "gnn":
        cfg = arch.model_cfg
        dims = arch.shapes[rec["shape"]].dims
        h = cfg.d_hidden
        E = dims["n_edges"] * dims.get("batch", 1)
        N = dims["n_nodes"] * dims.get("batch", 1)
        F = dims["d_feat"]
        fwd = cfg.n_layers * (
            2 * E * ((2 * h + 1) * h + h * h)  # edge MLP
            + 2 * E * (h * h + h)  # coord MLP
            + 2 * N * (2 * h * h + h * h)  # node MLP
        ) + 2 * N * F * h
        return 3 * fwd / n_dev  # train: fwd+bwd
    if arch.family == "recsys":
        cfg = arch.model_cfg
        dims = arch.shapes[rec["shape"]].dims
        B = dims.get("batch", 1)
        C = dims.get("n_candidates", 0)
        name = type(cfg).__name__
        if name == "SeqRecConfig":
            d = cfg.embed_dim
            blk = cfg.n_blocks * (4 * d * d + 3 * d * 4 * d)  # attn + glu mlp
            fwd = 2 * B * cfg.seq_len * blk
            if kind == "train":
                fwd += 2 * B * 256 * d  # sampled softmax
                return 3 * fwd / n_dev
            fwd += 2 * B * (C if C else 100) * d
            return fwd / n_dev
        if name == "DINConfig":
            d = 2 * cfg.embed_dim
            attn_p = 4 * d * cfg.attn_mlp[0] + cfg.attn_mlp[0] * cfg.attn_mlp[1] + cfg.attn_mlp[1]
            mlp_p = (3 * d + cfg.d_user) * cfg.mlp[0] + cfg.mlp[0] * cfg.mlp[1] + cfg.mlp[1]
            rows = C if kind == "retrieval" else B
            fwd = 2 * rows * (cfg.seq_len * attn_p + mlp_p)
            return (3 if kind == "train" else 1) * fwd / n_dev
        # TwoTower
        t1, t2, t3 = cfg.tower
        d = cfg.embed_dim
        tower_p = (d + cfg.d_user) * t1 + t1 * t2 + t2 * t3
        item_p = 2 * d * t1 + t1 * t2 + t2 * t3
        if kind == "retrieval":
            fwd = 2 * (item_p * C + tower_p) + 2 * C * t3
        elif kind == "train":
            fwd = 3 * (2 * B * (tower_p + item_p) + 2 * B * B * t3)
        else:
            fwd = 2 * B * (tower_p + item_p) + 2 * B * t3
        return fwd / n_dev
    # search: useful work = one compare + select per posting slot
    postings = rec.get("meta", {}).get("postings", 0)
    return 2 * postings / n_dev


def analyze(rec: dict, archs) -> dict:
    meta = rec.get("meta", {})
    L = meta.get("n_layers", 1)
    flops = rec["cost"]["flops"]
    bytes_ = rec["cost"]["bytes_accessed"]
    coll = rec.get("collectives", {})
    once = sum(coll.get("once_bytes", {}).values())
    in_loop = sum(coll.get("in_loop_bytes", {}).values())
    coll_bytes = once + in_loop * L
    t_comp = flops / PEAK_FLOPS[rec.get("compute_dtype", "bfloat16")]
    t_mem = bytes_ / HBM_BW
    t_coll = coll_bytes / LINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(rec, archs)
    util = mf / flops if flops else 0.0
    bound = max(terms.values())
    roofline_frac = t_comp / bound if bound else 0.0
    suggestions = {
        "compute": "compute-bound: raise MFU (fuse smalls, widen microbatch)",
        "memory": "memory-bound: cut bytes (quantize KV/params, fuse, remat less)",
        "collective": "collective-bound: overlap comm/compute, reshard to shrink gathers",
    }
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "kind": rec["kind"],
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_dev": mf,
        "hlo_flops_per_dev": flops,
        "useful_flops_ratio": util,
        "roofline_fraction": roofline_frac,
        "peak_gib": rec["memory"]["peak_per_device_gib"],
        "note": suggestions[dominant],
    }


def _gib(x) -> str:
    return "null" if x is None else f"{x:.1f}"


def to_markdown(rows: list[dict]) -> str:
    hdr = (
        "| arch | shape | mesh | compute s | memory s | collective s | dominant | "
        "MODEL/HLO flops | roofline frac | peak GiB |\n"
        "|---|---|---|---|---|---|---|---|---|---|\n"
    )
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['t_compute_s']:.2e} | "
            f"{r['t_memory_s']:.2e} | {r['t_collective_s']:.2e} | **{r['dominant']}** | "
            f"{r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.2f} | {_gib(r['peak_gib'])} |\n"
        )
    return "".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun.jsonl")
    ap.add_argument("--out", default="results/roofline.md")
    ap.add_argument("--json-out", default="results/roofline.json")
    args = ap.parse_args()
    from repro_torch.configs.registry import ARCHS

    rows = []
    seen = set()
    for line in Path(args.dryrun).read_text().splitlines():
        rec = json.loads(line)
        if "error" in rec:
            continue
        key = (rec["arch"], rec["shape"], rec["mesh"])
        if key in seen:
            continue
        seen.add(key)
        rows.append(analyze(rec, ARCHS))
    rows.sort(key=lambda r: (r["mesh"], r["arch"], r["shape"]))
    md = to_markdown(rows)
    Path(args.out).write_text(md)
    Path(args.json_out).write_text(json.dumps(rows, indent=1))
    print(md)
    # hillclimb candidates
    worst = min(rows, key=lambda r: r["roofline_fraction"])
    most_coll = max(rows, key=lambda r: r["t_collective_s"])
    print(f"\nworst roofline fraction: {worst['arch']}/{worst['shape']} = {worst['roofline_fraction']:.3f}")
    print(f"most collective-bound:  {most_coll['arch']}/{most_coll['shape']} = {most_coll['t_collective_s']:.2e}s")


if __name__ == "__main__":
    main()
