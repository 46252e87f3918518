"""Train-step builder: microbatching, remat, int8 gradient compression.

The port's counterpart of the JAX package's ``runtime/train.py``.
``make_train_step`` builds the step for a model from the runtime knobs:

  * ``microbatches`` — gradient accumulation over batch slices, float32
    accumulators, each slice's loss averaged;
  * ``remat``        — the activation-checkpoint policy of each layer body
    ("none" | "dots" | "dots_no_batch" | "full", see
    ``repro_torch.models.lm.REMAT_POLICIES``), ``remat_group`` layers a
    checkpointed unit;
  * ``loss_chunks``  — sequence-chunked unembedding and loss.

``make_dp_train_step_int8`` is the explicit data-parallel variant over
``torch.distributed``: each rank takes its slice of the batch, the ranks
agree on per-tensor scales (all-reduce MAX), sum their int8 gradients in
int32 (all-reduce SUM) and keep their quantisation error for the next step.

A step is ``(state, batch) -> (state, metrics)``.  It updates the model's
parameters, the moments and the error feedback in place (the JAX steps
donate their state) and returns the same state with the new step count.
The model's parameters must require grad (the trainer turns them on:
serving keeps them off).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM, forward_backbone
from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.optim.compress import (CompressionState, compress_gradients,
                                        decompress_sum, init_compression,
                                        shared_scale)
from repro_torch.runtime.loss import chunked_xent

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: LM
    opt: OptState
    compression: Optional[CompressionState] = None


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """The runtime knobs.  The reference's ``data_axes`` and ``act_spec``
    (GSPMD sharding of the batch and the residual stream) have no
    counterpart here."""

    microbatches: int = 1
    remat: Optional[str] = "dots_no_batch"
    remat_group: int = 1               # checkpoint every k layers
    remat_inner: Optional[str] = None  # per-layer policy inside a group
                                       # (None = same as ``remat``)
    loss_chunks: int = 1
    aux_weight: float = 0.01           # MoE load-balance loss weight


def trainable(model: LM) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, each set to require grad."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def init_state(model: LM, optimizer: AdamW, *,
               compress: bool = False) -> TrainState:
    params = trainable(model)
    return TrainState(params=model, opt=optimizer.init(params),
                      compression=init_compression(params) if compress
                      else None)


def make_loss_fn(cfg: ModelConfig, rt: RuntimeConfig):
    """(model, tokens, labels, extras) -> (loss + aux_weight * aux, (loss,
    aux)); ``extras`` (a VLM's ``frontend_embeds``) go to the model."""
    def loss_fn(model: LM, tokens: torch.Tensor, labels: torch.Tensor,
                extras: Optional[Batch] = None):
        x, aux = forward_backbone(model, tokens, remat_policy=rt.remat,
                                  remat_group=rt.remat_group,
                                  remat_inner_policy=rt.remat_inner,
                                  **(extras or {}))
        tot, cnt = chunked_xent(x, model.embed, cfg, labels,
                                chunks=rt.loss_chunks)
        loss = tot / torch.clamp(cnt, min=1.0)
        return loss + rt.aux_weight * aux, (loss, aux)

    return loss_fn


def _grads(loss_fn, model: LM, params: Dict[str, torch.Tensor],
           tokens: torch.Tensor, labels: torch.Tensor, extras: Batch):
    total, (loss, aux) = loss_fn(model, tokens, labels, extras)
    names = list(params)
    gs = torch.autograd.grad(total, [params[k] for k in names])
    return dict(zip(names, gs)), loss.detach(), aux.detach()


def _accumulate_grads(loss_fn, model: LM, batch: Batch, rt: RuntimeConfig):
    """Gradients of the batch's loss, by parameter name, and the loss and
    aux averaged over the microbatches.  With M > 1 microbatches dividing
    the batch, the batch is taken M slices in turn and the gradients summed
    in float32; otherwise (the reference's fallback) in one pass.  Every
    batch key but the tokens and the labels is an extra of the model's,
    sliced with them."""
    params = dict(model.named_parameters())
    tokens, labels = batch["tokens"], batch["labels"]
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    M, B = rt.microbatches, tokens.shape[0]
    if M <= 1 or B % M:
        return _grads(loss_fn, model, params, tokens, labels, extras)
    n = B // M
    g_acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    l_acc = a_acc = 0.0
    for i in range(M):
        part = slice(i * n, (i + 1) * n)
        g, loss, aux = _grads(loss_fn, model, params, tokens[part],
                              labels[part],
                              {k: v[part] for k, v in extras.items()})
        for k in g_acc:
            g_acc[k] += g[k].float()
        l_acc, a_acc = l_acc + loss, a_acc + aux
    inv = 1.0 / M
    return ({k: v * inv for k, v in g_acc.items()}, l_acc * inv,
            a_acc * inv)


def _to_device(batch: Batch, device: torch.device) -> Batch:
    return {k: v.to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, optimizer: AdamW,
                    rt: RuntimeConfig = RuntimeConfig()
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Metrics]]:
    loss_fn = make_loss_fn(cfg, rt)

    def train_step(state: TrainState, batch: Batch
                   ) -> Tuple[TrainState, Metrics]:
        model = state.params
        batch = _to_device(batch, model.embed["tokens"].device)
        grads, loss, aux = _accumulate_grads(loss_fn, model, batch, rt)
        _, opt, gnorm = optimizer.update(
            grads, state.opt, dict(model.named_parameters()))
        del grads
        metrics = {"loss": loss, "aux_loss": aux, "grad_norm": gnorm,
                   "lr": optimizer.config.lr_at(opt.step)}
        return TrainState(model, opt, state.compression), metrics

    return train_step


# ---------------------------------------------------------------------------
# Explicit-DP step with int8 + error-feedback gradient sync
# ---------------------------------------------------------------------------

def make_dp_train_step_int8(cfg: ModelConfig, optimizer: AdamW,
                            rt: RuntimeConfig,
                            group: Optional[dist.ProcessGroup] = None):
    """Data-parallel step with the gradient sync under our control, over
    an initialised ``torch.distributed`` process group (gloo on the CPU,
    NCCL on the card; world size 1 is a group like any other).

    Every rank holds the whole model and optimizer state and is given the
    whole global batch; rank r computes the gradient of its slice (rows
    r·B/n .. (r+1)·B/n), the ranks agree on a per-tensor scale, quantise to
    int8, sum in int32 and decode the exact mean of the quantised
    gradients.  Each rank's quantisation error stays in its error-feedback
    state."""
    loss_fn = make_loss_fn(cfg, rt)

    def train_step(state: TrainState, batch: Batch
                   ) -> Tuple[TrainState, Metrics]:
        if state.compression is None:
            raise ValueError("the int8 step needs init_state(..., "
                             "compress=True)")
        n, r = dist.get_world_size(group), dist.get_rank(group)
        model = state.params
        B = batch["tokens"].shape[0]
        if B % n:
            raise ValueError(f"batch {B} not divisible by {n} ranks")
        rows = slice(r * (B // n), (r + 1) * (B // n))
        mine = _to_device({k: v[rows] for k, v in batch.items()},
                          model.embed["tokens"].device)
        grads, loss, aux = _accumulate_grads(loss_fn, model, mine, rt)
        scales = shared_scale(grads, state.compression, reduce=True,
                              group=group)
        q, comp = compress_gradients(grads, state.compression, scales)
        del grads
        names = list(q)
        flat = torch.cat([q[k].reshape(-1).to(torch.int32) for k in names])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        q_sum, off = {}, 0
        for k in names:
            q_sum[k] = flat[off:off + q[k].numel()].view(q[k].shape)
            off += q[k].numel()
        mean_g = decompress_sum(q_sum, scales, n)
        la = torch.stack([loss, aux])
        dist.all_reduce(la, op=dist.ReduceOp.SUM, group=group)
        la = la / n
        _, opt, gnorm = optimizer.update(
            mean_g, state.opt, dict(model.named_parameters()))
        for k, e in comp.error.items():
            state.compression.error[k].copy_(e)
        metrics = {"loss": la[0], "aux_loss": la[1], "grad_norm": gnorm,
                   "lr": optimizer.config.lr_at(opt.step)}
        return TrainState(model, opt, state.compression), metrics

    return train_step
