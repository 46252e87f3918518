"""Runtime of the port: serving (the step builders, the decode step's CUDA
graph, the prefill's CUDA graphs and the batched engine) and training
(loss, microbatching, remat, the int8 data-parallel step)."""
from repro_torch.runtime.graphs import DecodeGraph, PrefillGraphs
from repro_torch.runtime.loss import chunked_xent, xent_from_logits
from repro_torch.runtime.serve import (Request, ServeEngine, greedy,
                                       make_decode_step, make_prefill_step,
                                       sample)
from repro_torch.runtime.train import (RuntimeConfig, TrainState, init_state,
                                       make_dp_train_step_int8, make_loss_fn,
                                       make_train_step)

__all__ = ["DecodeGraph", "PrefillGraphs", "Request", "RuntimeConfig",
           "ServeEngine", "TrainState", "chunked_xent", "greedy", "init_state",
           "make_decode_step", "make_dp_train_step_int8", "make_loss_fn",
           "make_prefill_step", "make_train_step", "sample",
           "xent_from_logits"]
