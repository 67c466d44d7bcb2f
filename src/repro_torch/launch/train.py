"""Training launcher: the train loop on the port's mesh (the twin of
``repro.launch.train``).

The reference lays the step out on a data x model mesh of TPU chips; the
port's mesh is the one card (``launch.mesh.make_data_model_mesh``), with
the reference's shardings bound to it.  Smoke configs by default, the
published widths with ``--full``; the card unless ``--device`` names
another device.

    python -m repro_torch.launch.train --arch starcoder2-3b --steps 100 \\
        --batch 8 --seq 128 [--full] [--ckpt-dir ckpts] [--device cpu]

Resuming restores the parameters only, as the reference does: the Adam
moments start again from zero, the schedule from step 0 and the data
stream from its first batch (ROADMAP queue 3 items 15 and 16).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import sharding as sh
from repro_torch.configs.registry import ARCHS, get_config, get_smoke
from repro_torch.data.pipeline import make_lm_iter
from repro_torch.launch.mesh import make_data_model_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig, init_opt_state


def run(arch: str, steps: int, batch: int, seq: int, smoke: bool = True,
        ckpt_dir: str | None = None, ckpt_every: int = 100,
        log_every: int = 10, lr: float = 1e-3, seed: int = 0,
        callback=None, device: str | torch.device | None = None):
    """Train ``arch`` for ``steps`` steps from its latest checkpoint in
    ``ckpt_dir`` (or from seeded weights); returns (params, history).
    Float32 weights drawn with numpy from ``seed``."""
    cfg = get_smoke(arch) if smoke else get_config(arch)
    mesh = make_data_model_mesh(device=device)
    opt = OptConfig(lr=lr, warmup_steps=max(2, steps // 20), total_steps=steps)

    start = 0
    if ckpt_dir and (latest := ckpt.latest_step(ckpt_dir)) is not None:
        like = T.abstract_params(cfg, torch.float32)
        params = ckpt.restore(ckpt_dir, latest, like, device=mesh.device)
        start = latest
        print(f"resumed from step {latest}")
    else:
        params = T.init_lm(cfg, seed, device=mesh.device)
    opt_state = init_opt_state(params)

    p_sh = sh.param_shardings(params, mesh)
    params = sh.device_put(params, p_sh)
    step_fn = make_train_step(cfg, opt)

    it = make_lm_iter(cfg, batch, seq, seed=seed)
    history = []
    t0 = time.perf_counter()
    for step in range(start, start + steps):
        batch_np = next(it)
        params, opt_state, metrics = step_fn(params, opt_state, batch_np)
        if step % log_every == 0 or step == start + steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=step, wall_s=time.perf_counter() - t0)
            history.append(m)
            print(f"step {step:5d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.2f} lr={m['lr']:.2e} "
                  f"({m['wall_s']:.1f}s)", flush=True)
            if callback:
                callback(m)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, params)
    if ckpt_dir:
        ckpt.save(ckpt_dir, start + steps, params)
    return params, history


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (StarCoder2-3B's fits one "
                         "80 GB card with its Adam state)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(args.arch, args.steps, args.batch, args.seq, smoke=not args.full,
        ckpt_dir=args.ckpt_dir, lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
