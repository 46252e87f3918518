"""Runtime of the port: the serving step builders and the batched engine."""
from repro_torch.runtime.serve import (Request, ServeEngine, greedy,
                                       make_decode_step, make_prefill_step,
                                       sample)

__all__ = ["Request", "ServeEngine", "greedy", "make_decode_step",
           "make_prefill_step", "sample"]
