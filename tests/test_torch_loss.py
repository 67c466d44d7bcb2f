"""The port's ``transformer.loss_fn`` and its gradients against
``jax.value_and_grad`` of the reference's, on every smoke config in
``ARCHS`` (dense, moe, mamba, hybrid, enc-dec, VLM), with the reference's
weights carried over by ``params_from_jax`` and a batch whose labels are
-1 at some positions (masked out of the loss).

Bars: the loss, its nll and the router's aux within 1e-5 relative; each
leaf's gradient within 1e-4 of its L2 norm (float32 on the CPU, two
packages' reductions in other orders).  The reference's function is
compiled once per config; both sides run with the config's own remat.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as JT
from repro_torch.configs import registry as treg
from repro_torch.core.graph import tree_flatten_with_path
from repro_torch.models import transformer as TT
from repro_torch.train.loop import value_and_grad

torch.set_num_threads(1)

ARCHS = sorted(jreg.ARCHS)
B, S = 2, 12
LOSS_REL = 1e-5
GRAD_REL = 1e-4

_j_init = jax.jit(JT.init_lm, static_argnums=(0,))
_j_vg = jax.jit(jax.value_and_grad(JT.loss_fn, has_aux=True),
                static_argnums=(1,))


def batch_for(cfg, seed: int) -> dict:
    """A seeded numpy batch for ``cfg``: tokens, next-token labels with
    -1 at a few positions, and the stub frontend's embeds."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    labels[1, -1] = -1
    out = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.num_prefix_embeds:
        name = "encoder_embeds" if cfg.encoder_layers else "prefix_embeds"
        out[name] = (0.05 * rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model))).astype(np.float32)
    return out


@functools.cache
def _reference(arch):
    cfg = jreg.get_smoke(arch)
    params = jax.tree_util.tree_map(
        np.array, _j_init(cfg, jax.random.PRNGKey(0)))
    batch = batch_for(cfg, len(arch))
    (loss, metrics), grads = _j_vg(params, cfg,
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    return (params, batch, float(loss),
            {k: float(v) for k, v in metrics.items()},
            {jax.tree_util.keystr(p): np.asarray(g) for p, g in
             jax.tree_util.tree_flatten_with_path(grads)[0]})


def _keystr(path) -> str:
    return "".join(f"['{k}']" for k in path)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    params, batch, loss_j, metrics_j, grads_j = _reference(arch)
    cfg = treg.get_smoke(arch)
    tp = TT.params_from_jax(params, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (loss, metrics), grads = value_and_grad(
        lambda p: TT.loss_fn(p, cfg, tb), tp)
    assert abs(float(loss) - loss_j) <= LOSS_REL * abs(loss_j)
    assert set(metrics) == set(metrics_j) == {"nll", "aux"}
    for k in metrics:
        assert abs(float(metrics[k]) - metrics_j[k]) \
            <= LOSS_REL * max(abs(metrics_j[k]), 1e-12), k
    if cfg.moe is None:
        assert float(metrics["aux"]) == 0.0
    got = {_keystr(p): g for p, g in tree_flatten_with_path(grads)}
    assert list(got) == list(grads_j)
    for k, want in grads_j.items():
        g = got[k].numpy()
        assert g.shape == want.shape, k
        err = np.linalg.norm(g - want)
        assert err <= GRAD_REL * np.linalg.norm(want), (k, err)


def test_masked_labels_change_nothing_but_the_mean():
    """A -1 label drops its position: the loss equals the mean nll over
    the positions kept, computed from the logits."""
    cfg = treg.get_smoke("starcoder2-3b")
    p = TT.init_lm(cfg, 0, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in batch_for(cfg, 3).items()}
    with torch.no_grad():
        loss, m = TT.loss_fn(p, cfg, b)
        logits, _ = TT.forward(p, cfg, b["tokens"])
    lp = torch.log_softmax(logits, -1)
    keep = b["labels"] >= 0
    want = -lp[keep].gather(-1, b["labels"][keep].long()[:, None]).mean()
    assert torch.allclose(loss, want, rtol=1e-6, atol=0)
    assert float(m["nll"]) == float(loss)
