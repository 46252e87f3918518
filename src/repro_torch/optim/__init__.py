"""Optimizer substrate of the port: AdamW, schedules, int8 compression."""
from repro_torch.optim.adamw import (AdamW, AdamWConfig, OptState,
                                     global_norm, param_path, split_name)
from repro_torch.optim.compress import (CompressionState, compress_gradients,
                                        decompress_sum, dequantize_int8,
                                        init_compression, quantize_int8,
                                        shared_scale)
from repro_torch.optim.schedules import (constant, cosine_schedule,
                                         linear_warmup, wsd_schedule)

__all__ = [n for n in dir() if not n.startswith("_")]
