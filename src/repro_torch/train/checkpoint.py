"""Checkpointing: tensor tree -> sharded .npz files + JSON manifest,
resumable (the twin of ``repro.train.checkpoint``).

Layout:  <dir>/step_<n>/manifest.json + shard_<i>.npz, the reference's
own: leaves in sorted-key order, each stored under its tree path
("units/pos0/attn/wq/w") as key ``a<i>`` of its shard, shards capped at
``shard_bytes``.  Either package restores the other's checkpoints.
Leaves are written as numpy arrays (a tensor is copied to the host
first); ``restore`` gives tensors back on the device the caller names.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.core.graph import tree_flatten_with_path, tree_map_with_path
from repro_torch.device import get_device


def _path_str(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("checkpoint: bfloat16 leaves have no numpy "
                            "dtype here; save them as float32")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree: Any,
         shard_bytes: int = 512 * 1024 * 1024) -> str:
    out = os.path.join(directory, f"step_{step}")
    os.makedirs(out, exist_ok=True)
    manifest: dict[str, Any] = {"step": step, "leaves": [], "shards": 0}
    shard: dict[str, np.ndarray] = {}
    shard_size = 0
    si = 0

    def flush():
        nonlocal shard, shard_size, si
        if shard:
            np.savez(os.path.join(out, f"shard_{si}.npz"), **shard)
            si += 1
            shard, shard_size = {}, 0

    for path, leaf in tree_flatten_with_path(tree):
        arr = _host(leaf)
        if shard_size + arr.nbytes > shard_bytes and shard:
            flush()
        key = f"a{len(shard)}"
        shard[key] = arr
        manifest["leaves"].append(
            {"path": _path_str(path), "shard": si, "key": key,
             "dtype": str(arr.dtype), "shape": list(arr.shape)})
        shard_size += arr.nbytes
    flush()
    manifest["shards"] = si
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return out


def restore(directory: str, step: int, like: Any,
            device: str | torch.device | None = None) -> Any:
    """Restore into the structure of ``like``, a tree of tensors (meta
    tensors included): each leaf with ``like``'s dtype, on ``like``'s
    device, or for a meta leaf on ``device`` (resolved by
    :func:`repro_torch.device.get_device`)."""
    src = os.path.join(directory, f"step_{step}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    shards = [np.load(os.path.join(src, f"shard_{i}.npz"))
              for i in range(manifest["shards"])]
    dev = None

    def load(path, leaf):
        nonlocal dev
        name = _path_str(path)
        entry = by_path[name]
        arr = shards[entry["shard"]][entry["key"]]
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"{name}: checkpoint {arr.shape} vs model "
                             f"{tuple(leaf.shape)}")
        if leaf.device.type == "meta":
            dev = dev or get_device(device)
            target = dev
        else:
            target = leaf.device
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            target, leaf.dtype)

    try:
        return tree_map_with_path(load, like)
    finally:
        for z in shards:
            z.close()


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None
