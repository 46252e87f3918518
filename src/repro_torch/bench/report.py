"""Telemetry snapshots for the port's benchmark results, and the dry-run's
tables.

    PYTHONPATH=src python -m repro_torch.bench.report [--mesh NAME]

prints the dry-run's summary and, for each mesh present (or the one
named), its roofline table and its fit grid (arch x shape: peak GiB a
card, bottleneck, roofline fraction, bold where it fits) as markdown (the
port has no EXPERIMENTS.md to inject them into), from the artifacts of
:mod:`repro_torch.launch.dryrun`.
"""
from __future__ import annotations

import os

from repro_torch.bench.roofline import DRYRUN_DIR, MESH, MESHES, load_cells

GiB = 2 ** 30


def embed_metrics(result: dict, telemetry) -> dict:
    """Embed a telemetry metrics snapshot into a ``BENCH_*_torch.json``
    result, so the artifact carries the counters (plan-cache hit ratio,
    retries, per-device busy seconds, ...) behind its headline numbers.
    ``telemetry`` is a :class:`repro_torch.core.telemetry.Telemetry`."""
    from repro_torch.core.telemetry import metrics_block
    result["metrics"] = metrics_block(telemetry)
    return result


def host(value):
    """A host copy of one run output (a tensor, or a numpy array given at
    the edge): what the gates compare, bit for bit."""
    import torch
    return torch.as_tensor(value).detach().cpu().clone()


def write(result: dict, path: str) -> None:
    """Write ``result`` as indented JSON to ``path``, making its folder."""
    import json
    import os
    folder = os.path.dirname(path)
    if folder:
        os.makedirs(folder, exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)


def load(mesh: str = MESH, root: str = DRYRUN_DIR) -> dict:
    """{(arch, shape): record} of the untagged artifacts."""
    return {(d["arch"], d["shape"]): d for d in load_cells(mesh, root=root)}


def _present(root: str):
    return [m for m in MESHES if os.path.isdir(os.path.join(root, m))]


def dryrun_summary(root: str = DRYRUN_DIR) -> str:
    from repro_torch.launch.roofline import HBM_PER_CARD
    cap = HBM_PER_CARD / GiB
    out = ["", f"| mesh | cells traced | skips (assignment) | over "
           f"{cap:.2f} GiB |", "|---|---|---|---|"]
    for mesh in _present(root) or [MESH]:
        cells = load(mesh, root)
        run = [d for d in cells.values() if not d.get("skipped")]
        skip = [d for d in cells.values() if d.get("skipped")]
        over = [d for d in run if not d["memory"]["fits_hbm"]]
        out.append(f"| {mesh} | {len(run)} | {len(skip)} | {len(over)} |")
    out += ["",
            "Per-cell trace seconds, peak memory a card, FLOPs, HBM bytes, "
            "collective bytes, kernel calls and the roofline record are in "
            f"`{root}/<mesh>/<arch>--<shape>.json`.",
            ""]
    return "\n".join(out)


def roofline_table(root: str = DRYRUN_DIR, mesh: str = MESH) -> str:
    rows = ["",
            f"{mesh}: all terms in seconds per step on one H100 SXM5 at "
            "its spec-sheet peaks (989 TFLOP/s bf16 dense, 3.35 TB/s "
            "HBM3, 450 GB/s NVLink a direction); `useful` = MODEL_FLOPS / "
            "counted FLOPs; `frac` = roofline fraction; `mem` = peak live "
            "bytes a card; `coll` = collective bytes a card; `fits` = under "
            "the card's memory.",
            "",
            "| arch | shape | compute_s | memory_s | collective_s | "
            "bottleneck | useful | frac | mem/card | coll/card | fits |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), d in sorted(load(mesh, root).items()):
        if d.get("skipped"):
            rows.append(f"| {arch} | {shape} | — | — | — | skip "
                        f"(sub-quadratic rule) | — | — | — | — | — |")
            continue
        r, m = d["roofline"], d["memory"]
        coll = d["op_analysis"].get("total_collective_bytes", 0.0)
        rows.append(
            f"| {arch} | {shape} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | "
            f"{r['bottleneck']} | "
            f"{r['useful_fraction']:.3f} | {r['roofline_fraction']:.4f} | "
            f"{m['peak_per_card_bytes'] / GiB:.2f} GiB | "
            f"{coll / GiB:.2f} GiB | "
            f"{'yes' if m['fits_hbm'] else 'no'} |")
    rows.append("")
    return "\n".join(rows)


SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def fit_grid(root: str = DRYRUN_DIR, mesh: str = MESH) -> str:
    """arch x shape: peak GiB a card, the bottleneck's initial (Compute,
    Memory, coLlective) and the roofline fraction; bold where it fits."""
    cells = load(mesh, root)
    archs = list(dict.fromkeys(a for a, _ in sorted(cells)))
    rows = ["", f"| arch ({mesh}) | " + " | ".join(SHAPE_ORDER) + " |",
            "|---" * (len(SHAPE_ORDER) + 1) + "|"]
    for arch in archs:
        cols = []
        for shape in SHAPE_ORDER:
            d = cells.get((arch, shape))
            if d is None:
                cols.append("—")
            elif d.get("skipped"):
                cols.append("skip")
            else:
                m, r = d["memory"], d["roofline"]
                peak = f"{m['peak_per_card_bytes'] / GiB:.2f}"
                b = {"compute": "C", "memory": "M",
                     "collective": "L"}[r["bottleneck"]]
                cols.append(f"{'**' + peak + '**' if m['fits_hbm'] else peak}"
                            f" {b} {r['roofline_fraction']:.4f}")
        rows.append(f"| {arch} | " + " | ".join(cols) + " |")
    rows.append("")
    return "\n".join(rows)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mesh", default=None, help="one mesh (default all "
                    "present)")
    ap.add_argument("--root", default=DRYRUN_DIR)
    args = ap.parse_args(argv)
    print(dryrun_summary(args.root))
    for mesh in ([args.mesh] if args.mesh else _present(args.root)):
        print(roofline_table(args.root, mesh))
        print(fit_grid(args.root, mesh))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
