"""The three canonical steps each input-shape kind runs (the twin of
``repro.launch.steps``).

``make_train_step`` takes the gradient with ``torch.autograd`` and applies
AdamW in place (:mod:`repro_torch.train.optimizer`); the serving steps
call the port's ``prefill`` / ``decode_step``.  A batch may be numpy
arrays (the data pipeline's) or tensors: the train step moves it to the
parameters' device.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.train.loop import batch_to, value_and_grad
from repro_torch.train.optimizer import OptConfig, apply_updates


def make_train_step(cfg: ModelConfig, opt: OptConfig | None = None,
                    unroll: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``; ``params`` and ``opt_state`` are
    updated in place and returned."""
    opt = opt or OptConfig()

    def train_step(params, opt_state, batch):
        dev = opt_state["step"].device
        b = batch_to(batch, dev)

        def loss_fn(p):
            return T.loss_fn(p, cfg, b, unroll=unroll)

        (loss, _), grads = value_and_grad(loss_fn, params)
        params, opt_state, stats = apply_updates(params, grads, opt_state, opt)
        return params, opt_state, {"loss": loss, **stats}

    return train_step


def make_prefill_step(cfg: ModelConfig, unroll: bool = False) -> Callable:
    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch["tokens"],
                         prefix_embeds=batch.get("prefix_embeds"),
                         encoder_embeds=batch.get("encoder_embeds"),
                         unroll=unroll)

    return prefill_step


def make_serve_step(cfg: ModelConfig, unroll: bool = False) -> Callable:
    """One decode token with a KV/SSM cache of seq_len (the serve_step);
    the port's ``decode_step`` updates ``caches`` in place."""
    def serve_step(params, token, pos, caches):
        return T.decode_step(params, cfg, token, pos, caches, unroll=unroll)

    return serve_step


def step_for(cfg: ModelConfig, kind: str, unroll: bool = False) -> Callable:
    if kind == "train":
        return make_train_step(cfg, unroll=unroll)
    if kind == "prefill":
        return make_prefill_step(cfg, unroll=unroll)
    return make_serve_step(cfg, unroll=unroll)
