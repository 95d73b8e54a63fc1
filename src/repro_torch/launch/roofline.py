"""Roofline analysis from the dry run's records, on an NVIDIA H100's peaks.

Counterpart of ``repro.launch.roofline``. Per (arch x shape) cell of the
dry run (``launch/dryrun.py``), the three roofline terms of one rank's
step on the card this port targets:

    compute term    = FLOPs_per_rank / peak FLOP/s of the step's dtype  [s]
    memory term     = bytes_per_rank / HBM bytes/s                       [s]
    collective term = sum over kinds: wire bytes / the group's link rate [s]

FLOPs and bytes come from the dry run's probe-extrapolated counts: FLOPs
from ``torch.utils.flop_counter`` (matrix products and attention; no
elementwise work), bytes as each computing op's operands and results
(unfused: an upper bound of what the card moves). Collective bytes use
ring-algorithm accounting per op kind (``collective_bytes_on_wire``, the
reference's arithmetic):

    all-reduce      2 * size * (g-1)/g        (reduce-scatter + all-gather)
    all-gather      size * (g-1)/g            (size = full output)
    reduce-scatter  size * (g-1)/g
    all-to-all      size * (g-1)/g
    collective-permute  size

Also reports MODEL_FLOPS (6*N*D dense train / 6*N_active*D MoE train /
2*N*D inference) and the MODEL/counted ratio that exposes causal-masking,
capacity-factor and padding waste.

**The card** (NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit; NVIDIA's data
sheet, dense rates): bf16 989 TFLOP/s, TF32 495, fp32 67 (outside the
tensor cores), HBM3 3.35 TB/s, 80 GB. ``chip_smoke.py``'s kernel bounds
read the same constants.

**The topology** stated for the production meshes: HGX nodes of 8 cards.
Inside a node NVLink 4 gives each card 450 GB/s per direction; between
nodes each card has one 400 Gb/s NDR port, 50 GB/s. Ranks are numbered
row-major over the mesh, so on (16, 16) = (data, model) a model-axis group
is 16 consecutive ranks, two nodes, and a data-axis group strides over 16
nodes. A collective whose group spans more than one node goes at the
slower rate: a group of more than 8 ranks always does, a group of at most
8 is taken as one node's (a model axis of consecutive ranks).

**Dropped from the reference**, with the reason:

  * ``ragged_dense_overcount``: it corrects an XLA CPU-lowering artefact
    (``lax.ragged_dot`` lowered as a dense product against every local
    expert). The port's count has no such artefact: on meta tensors
    ``moe.py`` counts the grouped product as one product over the
    capacity-packed rows;
  * the v5e constants and the ICI-link term: the terms above take the
    card's peaks and the node topology instead.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir results/dryrun]
        [--mesh single] [--csv]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import dataclass
from typing import Dict

CARD = "NVIDIA H100 80GB HBM3, 700 W"
# peak FLOP/s by the dtype a product runs in (dense, no sparsity)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9             # bytes of device memory
NODE_CARDS = 8               # cards of one HGX node
NVLINK_BW = 450e9            # bytes/s per card per direction, inside a node
NET_BW = 50e9                # bytes/s per card between nodes (400 Gb/s NDR)


def peak_flops(dtype: str) -> float:
    """Peak FLOP/s of the card for products in ``dtype`` (a name such as
    ``"bfloat16"``, ``"float32"`` or ``"tf32"``)."""
    return PEAK_FLOPS[str(dtype).replace("torch.", "")]


def link_bw(group: int) -> float:
    """Bytes/s a card sends in a collective over ``group`` ranks."""
    return NVLINK_BW if group <= NODE_CARDS else NET_BW


def collective_bytes_on_wire(summary: Dict) -> float:
    """Per-rank bytes on the wire, ring-algorithm accounting."""
    total = 0.0
    for kind, rec in (summary or {}).items():
        size = rec.get("bytes", 0.0)
        g = rec.get("group") or 16
        if g <= 1:
            continue
        frac = (g - 1) / g
        if kind == "all-reduce":
            total += 2 * size * frac
        elif kind in ("all-gather", "reduce-scatter", "all-to-all"):
            total += size * frac
        elif kind == "collective-permute":
            total += size
    return total


def collective_seconds(summary: Dict) -> float:
    """The collective term: each kind's wire bytes at its group's rate."""
    return sum(collective_bytes_on_wire({k: rec})
               / link_bw(rec.get("group") or 16)
               for k, rec in (summary or {}).items())


def model_flops_per_device(arch: str, shape: str, n_devices: int) -> float:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    cfg = get_config(arch)
    sp = SHAPES[shape]
    n = cfg.n_active_params if cfg.moe else cfg.n_params
    if sp.kind == "train":
        tokens = sp.global_batch * sp.seq_len
        total = 6.0 * n * tokens
    elif sp.kind == "prefill":
        tokens = sp.global_batch * sp.seq_len
        total = 2.0 * n * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n * sp.global_batch
    return total / n_devices


@dataclass
class RooflineRow:
    arch: str
    shape: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    counted_flops: float = 0.0
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    step_time_s: float = 0.0
    roofline_frac: float = 0.0
    hbm_gib: float = 0.0
    fits: bool = True
    note: str = ""


def analyze_cell(rec: dict) -> RooflineRow:
    arch, shape = rec["arch"], rec["shape"]
    if rec.get("status") == "skipped":
        return RooflineRow(arch=arch, shape=shape, status="skipped",
                           note=rec.get("reason", ""))
    if rec.get("status") != "ok":
        return RooflineRow(arch=arch, shape=shape, status="error",
                           note=rec.get("error", "")[:100])
    cost = rec["cost"]
    flops = cost["flops"]
    compute_s = flops / peak_flops(rec.get("dtype", "bfloat16"))
    memory_s = cost["bytes_accessed"] / HBM_BW
    collective_s = collective_seconds(cost.get("collectives", {}))
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops_per_device(arch, shape, rec.get("n_devices", 256))
    # step time lower bound: the dominant term (perfect overlap assumption)
    step = max(terms.values())
    mem = rec.get("memory", {})
    hbm = (mem.get("argument_bytes", 0) + mem.get("output_bytes", 0)
           + mem.get("temp_bytes", 0) - mem.get("alias_bytes", 0))
    return RooflineRow(
        arch=arch, shape=shape, status="ok",
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, counted_flops=flops, model_flops=mf,
        useful_ratio=(mf / flops if flops else 0.0),
        step_time_s=step,
        roofline_frac=(compute_s / step if step else 0.0),
        hbm_gib=hbm / 2**30, fits=hbm <= HBM_BYTES, note="")


def load_rows(dir_: str, mesh: str = "single") -> list:
    rows = []
    for f in sorted(glob.glob(os.path.join(dir_, f"*_{mesh}.json"))):
        with open(f) as fh:
            rows.append(analyze_cell(json.load(fh)))
    return rows


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", type=str, default="results/dryrun")
    ap.add_argument("--mesh", type=str, default="single")
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args()

    rows = load_rows(args.dir, args.mesh)
    if args.csv:
        print("arch,shape,status,compute_s,memory_s,collective_s,bottleneck,"
              "counted_flops,model_flops,useful_ratio,roofline_frac,"
              "hbm_gib,fits")
        for r in rows:
            print(f"{r.arch},{r.shape},{r.status},{r.compute_s:.6g},"
                  f"{r.memory_s:.6g},{r.collective_s:.6g},{r.bottleneck},"
                  f"{r.counted_flops:.6g},{r.model_flops:.6g},"
                  f"{r.useful_ratio:.3f},{r.roofline_frac:.3f},"
                  f"{r.hbm_gib:.2f},{r.fits}")
        return

    print(f"# {CARD}: bf16 {PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s, "
          f"HBM {HBM_BW / 1e12:.2f} TB/s, {HBM_BYTES / 1e9:.0f} GB; "
          f"NVLink {NVLINK_BW / 1e9:.0f} GB/s inside a node of {NODE_CARDS}, "
          f"{NET_BW / 1e9:.0f} GB/s between nodes")
    hdr = (f"{'arch':<18}{'shape':<13}{'compute':>9}{'memory':>9}"
           f"{'coll':>9}{'bound':>11}{'MODEL/CNT':>10}{'roofl%':>8}"
           f"{'HBM GiB':>9}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        if r.status != "ok":
            print(f"{r.arch:<18}{r.shape:<13}  [{r.status}] {r.note[:60]}")
            continue
        print(f"{r.arch:<18}{r.shape:<13}{fmt_s(r.compute_s):>9}"
              f"{fmt_s(r.memory_s):>9}{fmt_s(r.collective_s):>9}"
              f"{r.bottleneck:>11}{r.useful_ratio:>10.2f}"
              f"{r.roofline_frac * 100:>7.1f}%"
              f"{r.hbm_gib:>9.1f}{'' if r.fits else '  (>80G!)'}")


if __name__ == "__main__":
    main()
