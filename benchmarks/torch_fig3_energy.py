"""Fig 3 on the port: per-node energy per inference cycle, DEFER vs single
device (ResNet50, 4/6/8 nodes).  Twin of ``benchmarks/fig3_energy.py``."""
from __future__ import annotations

from benchmarks.torch_common import emit, graph_and_params
from repro_torch.core.emulator import CodecConfig, emulate


def run(nodes=(4, 6, 8)) -> list[dict]:
    g, _ = graph_and_params("resnet50")
    cfg = CodecConfig(serializer="zfp", compression="none", zfp_rate=16)
    rows = []
    for n in nodes:
        rep = emulate(g, n, cfg)
        rows.append({
            "nodes": n,
            "per_node_energy_j": rep.per_node_energy_j,
            "single_device_energy_j": rep.single_device_energy_j,
            "energy_ratio": rep.energy_ratio,
        })
    return rows


def main() -> None:
    emit("torch_fig3_energy", run())


if __name__ == "__main__":
    main()
