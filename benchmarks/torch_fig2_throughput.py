"""Fig 2 on the port: inference throughput for {VGG16, VGG19, ResNet50} x
{1, 4, 6, 8} compute nodes under the emulated DEFER chain (paper's CORE
setting).  Twin of ``benchmarks/fig2_throughput.py``."""
from __future__ import annotations

from benchmarks.torch_common import emit, graph_and_params
from repro_torch.core.emulator import CodecConfig, emulate


def run(models=("vgg16", "vgg19", "resnet50"), nodes=(4, 6, 8)) -> list[dict]:
    rows = []
    cfg = CodecConfig(serializer="zfp", compression="none", zfp_rate=16)
    for model in models:
        g, _ = graph_and_params(model)
        single = None
        for n in nodes:
            rep = emulate(g, n, cfg)
            single = rep.single_device_cps
            rows.append({
                "model": model, "nodes": n,
                "throughput_cps": rep.throughput_cps,
                "single_device_cps": rep.single_device_cps,
                "speedup": rep.speedup,
            })
        rows.append({"model": model, "nodes": 1, "throughput_cps": single,
                     "single_device_cps": single, "speedup": 1.0})
    return rows


def main() -> None:
    emit("torch_fig2_throughput", run())


if __name__ == "__main__":
    main()
