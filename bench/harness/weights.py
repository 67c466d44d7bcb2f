"""Weights drawn on the device from the seed, in two large calls.

A model's weights are a tree of leaves, each with a law: ``("normal",
std)`` or ``("uniform", lo, hi)``.  All normal leaves are views of one
``randn`` buffer and all uniform ones of one ``rand`` buffer, drawn in the
order of the leaf list by one generator on the device, so the same seed on
the same kind of device gives the same weights in every process.
"""
from __future__ import annotations

import torch

from bench.harness.load import stream_seed


def draw(leaves: list[tuple[tuple[str, ...], tuple[int, ...], tuple]],
         seed: int, device) -> dict:
    """The tree {path[0]: {path[1]: ... tensor}} of ``leaves`` given as
    (path, shape, law), f32 on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 1))
    sizes = {"normal": 0, "uniform": 0}
    for _, shape, law in leaves:
        sizes[law[0]] += _numel(shape)
    bufs = {"normal": torch.randn(sizes["normal"], generator=gen,
                                  device=device),
            "uniform": torch.rand(sizes["uniform"], generator=gen,
                                  device=device)}
    at = {"normal": 0, "uniform": 0}
    tree: dict = {}
    for path, shape, law in leaves:
        n = _numel(shape)
        t = bufs[law[0]][at[law[0]]:at[law[0]] + n]
        at[law[0]] += n
        if law[0] == "normal":
            t.mul_(law[1])
        else:
            t.mul_(law[2] - law[1]).add_(law[1])
        d = tree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = t.view(shape)
    return tree


def to_host(tree: dict) -> dict:
    """The same tree as numpy arrays (one copy of each leaf)."""
    return {k: (to_host(v) if isinstance(v, dict) else v.cpu().numpy())
            for k, v in tree.items()}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
