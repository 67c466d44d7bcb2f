"""The check catches a broken timed path: each fault a cell can have is
planted underneath a whole run on the CPU (the look for a card skipped),
and ``correct`` must come out false.

For the CNN cell, on either wire: an answer altered where it is produced
(the fully connected layer adds 1 to one logit of every row) and half of
a wave left out, the mean of the rest taken in its place (the global
pool).  For the decode cell: a step that returns its state unchanged (attention's cache
is not written) and a token altered where it is produced (the head).  No
cell crosses chips, so there is no exchange to leave out."""
from __future__ import annotations

import pytest
import torch

from conftest import run_tiny, tiny


def _altered_fc(real):
    def fc(p, x, *, relu):
        y = real(p, x, relu=relu)
        return torch.cat([y[:, :1] + 1.0, y[:, 1:]], dim=1)
    return fc


def _half_batch(real):
    def gap(p, x):
        y = real(p, x)
        k = y.shape[0] // 2
        if k:
            y = y.clone()
            y[k:] = y[:k].mean(dim=0, keepdim=True)
        return y
    return gap


@pytest.mark.parametrize("wire", ["q8", "raw"])
@pytest.mark.parametrize("fault", ["altered_answer", "half_batch"])
def test_a_cnn_fault_makes_the_run_incorrect(monkeypatch, wire, fault):
    from repro_torch.models import cnn
    if fault == "altered_answer":
        monkeypatch.setattr(cnn, "fc_apply", _altered_fc(cnn.fc_apply))
    else:
        monkeypatch.setattr(cnn, "gap_apply", _half_batch(cnn.gap_apply))
    res = run_tiny(tiny("resnet50.q8.closed8", wire=wire), seconds=3.0)
    assert res["correct"] is False
    assert res["checks"]["logits_rel_err"]["value"] \
        > res["checks"]["logits_rel_err"]["limit"]


def test_a_decode_step_that_keeps_its_state_makes_the_run_incorrect(
        monkeypatch):
    from repro_torch.models import lm_graph
    real = lm_graph.attention_decode

    def stale(p, s, x, pos, cache, kpos, **kw):
        copy = {k: v.clone() for k, v in cache.items()}
        out, _, _ = real(p, s, x, pos, copy, kpos.clone(), **kw)
        return out, cache, kpos
    monkeypatch.setattr(lm_graph, "attention_decode", stale)
    res = run_tiny(tiny("starcoder2-3b.decode.closed8"), seconds=3.0)
    assert res["correct"] is False
    assert res["checks"]["logits_rel_err"]["value"] \
        > res["checks"]["logits_rel_err"]["limit"]


def test_a_token_altered_at_the_head_makes_the_run_incorrect(monkeypatch):
    from repro_torch.models import lm_graph
    real = lm_graph._head

    def head(p, x):
        y = real(p, x)
        return torch.cat([y[..., :1] + 100.0, y[..., 1:]], dim=-1)
    monkeypatch.setattr(lm_graph, "_head", head)
    res = run_tiny(tiny("starcoder2-3b.decode.closed8"), seconds=3.0)
    assert res["correct"] is False
    assert res["checks"]["logits_rel_err"]["value"] > 1.0
