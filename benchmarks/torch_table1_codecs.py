"""Table I on the port: energy / overhead / network payload for ResNet50
with 4 compute nodes, per payload type (architecture / weights / data) x
codec config.  Twin of ``benchmarks/table1_codecs.py``."""
from __future__ import annotations

from benchmarks.torch_common import emit, graph_and_params
from repro_torch.core.emulator import CodecConfig, emulate_config_step

CONFIGS = [("json", "lz4"), ("json", "none"), ("zfp", "lz4"), ("zfp", "none")]


def run() -> list[dict]:
    g, _ = graph_and_params("resnet50")
    rows = []
    for ser, comp in CONFIGS:
        cfg = CodecConfig(serializer=ser, compression=comp, zfp_rate=16)
        reports = emulate_config_step(g, 4, cfg)
        for kind in ("architecture", "weights", "data"):
            # architecture is always JSON-serialized (it's a layer spec);
            # the paper's Table I varies only its compression
            if kind == "architecture" and ser == "zfp":
                continue
            r = reports[kind]
            rows.append({
                "type": kind, "serialization": ser.upper(),
                "compression": "LZ4" if comp == "lz4" else "Uncompressed",
                "energy_j": r.energy_j, "overhead_s": r.overhead_s,
                "payload_mb": r.payload_mb,
            })
    return rows


def main() -> None:
    emit("torch_table1_codecs", run())


if __name__ == "__main__":
    main()
