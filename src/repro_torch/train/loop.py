"""Training loop: the train step + a host loop with metrics (the twin of
``repro.train.loop``).

``make_train_step`` is loss (next-token CE + router aux) -> grads
(``torch.autograd``) -> AdamW in place.  Activation checkpointing is
applied per unit inside the model when ``cfg.remat`` (policy "full":
nothing saved across units but their inputs).  The loop moves each numpy
batch to the parameters' device.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import tree_flatten_with_path, tree_map, \
    tree_map_with_path
from repro_torch.device import get_device
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import OptConfig, apply_updates, \
    init_opt_state


def batch_to(batch: dict, device: torch.device) -> dict:
    """A batch's arrays as tensors on ``device``."""
    return tree_map(lambda a: torch.as_tensor(a).to(device), batch)


def value_and_grad(loss_fn: Callable, params: Any, *args):
    """(loss, aux), grads of ``loss_fn(params, *args) -> (loss, aux)``
    with respect to every leaf of ``params`` (``jax.value_and_grad`` with
    ``has_aux``): grads in ``params``' tree, zeros where a leaf is unused.
    The leaves are set to require grad."""
    flat = list(tree_flatten_with_path(params))
    for _, leaf in flat:
        leaf.requires_grad_(True)
    loss, aux = loss_fn(params, *args)
    grads = torch.autograd.grad(loss, [leaf for _, leaf in flat],
                                allow_unused=True, materialize_grads=True)
    by_path = {path: g for (path, _), g in zip(flat, grads)}
    aux = tree_map(lambda t: t.detach(), aux)
    return (loss.detach(), aux), tree_map_with_path(
        lambda path, _: by_path[path], params)


def make_loss_fn(cfg: ModelConfig, use_kernel: bool = False):
    def loss_fn(params, batch):
        return T.loss_fn(params, cfg, batch, use_kernel)
    return loss_fn


def make_train_step(cfg: ModelConfig, opt: OptConfig,
                    use_kernel: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: metrics are the loss's ("nll", "aux"), the optimizer's
    ("grad_norm", "lr") and "loss", each a 0-d tensor.  ``use_kernel``
    reaches the CUDA kernels, which have no backward: on the card it
    raises."""
    loss_fn = make_loss_fn(cfg, use_kernel)

    def train_step(params, opt_state, batch):
        b = batch_to(batch, opt_state["step"].device)
        (loss, metrics), grads = value_and_grad(loss_fn, params, b)
        params, opt_state, stats = apply_updates(params, grads, opt_state, opt)
        metrics = dict(metrics)
        metrics.update(stats)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def train(cfg: ModelConfig, opt: OptConfig, data_iter, num_steps: int,
          key: int | np.random.Generator | None = None, params=None,
          use_kernel: bool = False, log_every: int = 10, callback=None,
          device: str | torch.device | None = None):
    """Single-device training loop.  ``key`` seeds ``init_lm`` (an int or
    a numpy Generator; 0 by default) when no ``params`` are given; they
    are drawn on ``device`` (the card unless the caller asks for the
    CPU).  Returns (params, opt_state, history); ``params`` are updated
    in place."""
    if params is None:
        params = T.init_lm(cfg, 0 if key is None else key,
                           device=get_device(device))
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt, use_kernel)
    history = []
    t0 = time.perf_counter()
    for step in range(num_steps):
        batch = next(data_iter)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            if callback:
                callback(m)
    return params, opt_state, history
