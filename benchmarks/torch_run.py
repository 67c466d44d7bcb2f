"""Runner of the paper's tables and figures on the port.

    PYTHONPATH=src:. python -m benchmarks.torch_run [--only name,name]

Emits CSV blocks to stdout and artifacts/bench/torch_*.csv (the
reference's ``benchmarks.run`` writes the same names without the prefix).
Imports neither ``jax`` nor the reference package; everything here is
host numpy (the emulator's codecs are JSON, ZFP and LZ4).
"""
from __future__ import annotations

import argparse
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated benchmark names")
    args = ap.parse_args()

    from benchmarks import (torch_fig2_throughput, torch_fig3_energy,
                            torch_table1_codecs,
                            torch_table2_codec_throughput)
    benches = {
        "fig2_throughput": torch_fig2_throughput.main,
        "table1_codecs": torch_table1_codecs.main,
        "table2_codec_throughput": torch_table2_codec_throughput.main,
        "fig3_energy": torch_fig3_energy.main,
    }
    names = args.only.split(",") if args.only else list(benches)
    failed = []
    for name in names:
        t0 = time.perf_counter()
        try:
            benches[name]()
            print(f"# {name} done in {time.perf_counter()-t0:.1f}s\n")
        except Exception as e:  # deferlint: swallow(recorded in failed[]; run exits nonzero below)
            failed.append(name)
            print(f"# {name} FAILED: {type(e).__name__}: {e}\n")
    if failed:
        sys.exit(f"benchmarks failed: {failed}")


if __name__ == "__main__":
    main()
