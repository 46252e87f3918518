"""Telemetry snapshots for the port's benchmark results, and the dry-run's
tables.

    PYTHONPATH=src python -m repro_torch.bench.report

prints the single-H100 dry-run's summary and roofline table as markdown
(the port has no EXPERIMENTS.md to inject them into), from the artifacts
of :mod:`repro_torch.launch.dryrun`.
"""
from __future__ import annotations

from repro_torch.bench.roofline import DRYRUN_DIR, MESH, load_cells

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


def dryrun_summary(root: str = DRYRUN_DIR) -> str:
    from repro_torch.launch.roofline import HBM_PER_CARD
    cap = HBM_PER_CARD / GiB
    out = ["", f"| mesh | cells traced | skips (assignment) | over "
           f"{cap:.2f} GiB |", "|---|---|---|---|"]
    cells = load(MESH, root)
    run = [d for d in cells.values() if not d.get("skipped")]
    skip = [d for d in cells.values() if d.get("skipped")]
    over = [d for d in run if not d["memory"]["fits_hbm"]]
    out.append(f"| {MESH} | {len(run)} | {len(skip)} | {len(over)} |")
    out += ["",
            "Per-cell trace seconds, peak memory a card, FLOPs, HBM bytes, "
            "kernel calls and the roofline record are in "
            f"`{root}/{MESH}/<arch>--<shape>.json`.",
            ""]
    return "\n".join(out)


def roofline_table(root: str = DRYRUN_DIR) -> str:
    rows = ["",
            "All terms in seconds per step on one H100 SXM5 at its "
            "spec-sheet peaks (989 TFLOP/s bf16 dense, 3.35 TB/s HBM3); "
            "`useful` = MODEL_FLOPS / counted FLOPs; `frac` = roofline "
            "fraction; `mem` = peak live bytes a card; `fits` = under the "
            "card's memory.",
            "",
            "| arch | shape | compute_s | memory_s | bottleneck | useful | "
            "frac | mem/card | fits |",
            "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), d in sorted(load(MESH, root).items()):
        if d.get("skipped"):
            rows.append(f"| {arch} | {shape} | — | — | skip "
                        f"(sub-quadratic rule) | — | — | — | — |")
            continue
        r, m = d["roofline"], d["memory"]
        rows.append(
            f"| {arch} | {shape} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['bottleneck']} | "
            f"{r['useful_fraction']:.3f} | {r['roofline_fraction']:.4f} | "
            f"{m['peak_per_card_bytes'] / GiB:.2f} GiB | "
            f"{'yes' if m['fits_hbm'] else 'no'} |")
    rows.append("")
    return "\n".join(rows)


def main() -> int:
    print(dryrun_summary())
    print(roofline_table())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
