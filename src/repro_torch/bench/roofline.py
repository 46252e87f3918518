"""Roofline tables from the dry-run's artifacts.

The port's counterpart of the JAX package's ``benchmarks/roofline.py``.
Reads ``build/dryrun_torch/<mesh>/*.json``
(:mod:`repro_torch.launch.dryrun`) and renders, per mesh present (one
H100, then quad_2x2, pod_32x8 and multipod_2x32x8) and per (arch x shape)
cell: the roofline terms (the collective one is 0 on one card), the
dominant bottleneck, MODEL_FLOPS / counted FLOPs (remat and redundancy
waste), the roofline fraction and the peak memory a card.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional

DRYRUN_DIR = "build/dryrun_torch"
MESH = "single_h100"
#: the dry-run's meshes, in the order the tables print them
MESHES = (MESH, "quad_2x2", "pod_32x8", "multipod_2x32x8")


def load_cells(mesh: str = MESH, tag: Optional[str] = None,
               root: str = DRYRUN_DIR) -> List[Dict]:
    """The cells' records, sorted by file name; without ``tag`` the
    untagged ones (a tagged artifact is ``<arch>--<shape>--<tag>.json``)."""
    pat = f"*--{tag}.json" if tag else "*.json"
    out = []
    for p in sorted(glob.glob(os.path.join(root, mesh, pat))):
        if tag is None and os.path.basename(p)[:-5].count("--") > 1:
            continue                      # hillclimb variants
        with open(p) as f:
            out.append(json.load(f))
    return out


def render(mesh: str = MESH, root: str = DRYRUN_DIR) -> List[str]:
    cells = load_cells(mesh, root=root)
    lines: List[str] = []
    print(f"== roofline ({mesh}) ==")
    print(f"{'arch':22s} {'shape':12s} {'compute_s':>10s} {'memory_s':>9s} "
          f"{'coll_s':>8s} {'bneck':>7s} {'useful':>7s} {'frac':>7s} "
          f"{'mem/card':>9s}")
    for d in cells:
        if d.get("skipped"):
            print(f"{d['arch']:22s} {d['shape']:12s} "
                  f"SKIP ({d['skipped'][:60]}...)")
            lines.append(f"roofline,{d['arch']},{d['shape']},skip")
            continue
        r, m = d["roofline"], d["memory"]
        print(f"{d['arch']:22s} {d['shape']:12s} {r['compute_s']:>10.4f} "
              f"{r['memory_s']:>9.4f} {r['collective_s']:>8.4f} "
              f"{r['bottleneck'][:7]:>7s} {r['useful_fraction']:>7.3f} "
              f"{r['roofline_fraction']:>7.4f} "
              f"{m['peak_per_card_bytes'] / 2**30:>8.2f}G")
        lines.append(
            f"roofline,{d['arch']},{d['shape']},{r['compute_s']:.5f},"
            f"{r['memory_s']:.5f},{r['collective_s']:.5f},"
            f"{r['bottleneck']},{r['roofline_fraction']:.5f}")
    return lines


def collect(full: bool = False, testbed: str = "host", device: str = "cuda",
            smoke: bool = False, root: str = DRYRUN_DIR) -> Dict[str, Any]:
    """The table's CSV lines (``repro_torch.bench.run``'s interface; the
    artifacts are what they are, whatever the testbed or size)."""
    lines: List[str] = []
    for mesh in MESHES:
        if os.path.isdir(os.path.join(root, mesh)):
            lines.extend(render(mesh, root))
    if not lines:
        print("no dry-run artifacts found — run "
              "`python -m repro_torch.launch.dryrun` first")
    return {"lines": lines}


def main(full: bool = False, testbed: str = "host", device: str = "cuda",
         smoke: bool = False) -> List[str]:
    return collect(full, testbed, device, smoke)["lines"]


if __name__ == "__main__":
    main()
