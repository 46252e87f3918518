"""Telemetry snapshots for the port's benchmark results."""
from __future__ import annotations


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
