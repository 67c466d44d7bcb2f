"""Table II on the port: inference throughput of ResNet50/4-nodes per
data-socket codec configuration (the steady-state pipeline rate including
codec overhead).  Twin of ``benchmarks/table2_codec_throughput.py``."""
from __future__ import annotations

from benchmarks.torch_common import emit, graph_and_params
from repro_torch.core.emulator import CodecConfig, emulate

CONFIGS = [("json", "lz4"), ("json", "none"), ("zfp", "lz4"), ("zfp", "none")]


def run() -> list[dict]:
    g, _ = graph_and_params("resnet50")
    rows = []
    for ser, comp in CONFIGS:
        cfg = CodecConfig(serializer=ser, compression=comp, zfp_rate=16)
        rep = emulate(g, 4, cfg)
        rows.append({
            "serialization": ser.upper(),
            "compression": "LZ4" if comp == "lz4" else "Uncompressed",
            "throughput_cps": rep.throughput_cps,
            "payload_mb": rep.total_payload_mb,
            "overhead_s": rep.overhead_s,
        })
    return rows


def main() -> None:
    emit("torch_table2_codec_throughput", run())


if __name__ == "__main__":
    main()
