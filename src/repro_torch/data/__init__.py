"""Deterministic, shard-resumable synthetic data pipeline of the port."""
from repro_torch.data.pipeline import (DataConfig, SyntheticLM, batch_at,
                                       host_shard_batch)

__all__ = ["DataConfig", "SyntheticLM", "batch_at", "host_shard_batch"]
