"""The whole command path on the CPU at a tiny size, and the ways a run
must refuse: no card, a checkout without the program, JAX in the
process."""
from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, run_tiny, tiny

# each cell, and the ResNet50 chain on the raw wire, which no cell runs yet
CELLS = [("resnet50.q8.closed8", {}), ("resnet50.q8.closed8", {"wire": "raw"}),
         ("starcoder2-3b.decode.closed8", {})]


@pytest.mark.parametrize("name,traffic", CELLS)
def test_a_tiny_cell_runs_the_whole_path_and_is_correct(name, traffic):
    res = run_tiny(tiny(name, **traffic))
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    assert list(res)[-1] == "checks"


def test_an_open_loop_mix_runs_the_whole_path_and_is_correct():
    """The generator's Poisson loop, which no cell uses yet, on the tiny
    q8 chain: every request answered and correct, the sender's lateness
    printed."""
    import io
    import json
    import time

    import torch

    from bench.harness import cell as cell_mod
    c = tiny("resnet50.q8.closed8")
    c.traffic = dict(c.traffic, loop="poisson", rate_per_s=8.0)
    out, err = io.StringIO(), io.StringIO()
    res = cell_mod.measure(c, 2**31 + 9, 2.0, False, torch.device("cpu"),
                           time.perf_counter(), out=out, err=err)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] == 16 and res["failed"] == 0
    late = [json.loads(x) for x in err.getvalue().splitlines()
            if x.startswith('{"sender_late_ms"')]
    assert late and late[0]["sender_late_ms"]["max"] >= 0


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    p = _run(["--workload", "resnet50.q8.closed8", "--seed", "5",
              "--seconds", "1", "--trace", "0"], ROOT,
             dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", "resnet50.q8.closed8", "--seed", "5",
              "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_nothing_of_the_jax_package():
    """In a fresh process, a tiny run leaves no module whose top-level
    name is jax, jaxlib, flax or repro (repro_torch is the port)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "sys.path.insert(0, %r)\n"
        "from conftest import run_tiny, tiny\n"
        "run_tiny(tiny('resnet50.q8.closed8'), seconds=1.0)\n"
        "from bench.harness.cell import forbidden_modules\n"
        "print('FORBIDDEN', forbidden_modules())\n"
        "print('PORT', 'repro_torch' in sys.modules)\n"
    ) % (ROOT, os.path.join(ROOT, "src"), os.path.dirname(__file__))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "FORBIDDEN []" in p.stdout and "PORT True" in p.stdout


def test_the_guard_names_the_jax_package_by_its_whole_top_level_name():
    from bench.harness import cell
    sys.modules["repro_fake_child"] = sys.modules[__name__]
    try:
        assert "repro_fake_child" not in cell.forbidden_modules()
    finally:
        del sys.modules["repro_fake_child"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("f", sorted(os.listdir(
    os.path.join(ROOT, "bench", "reference"))))
def test_the_reference_imports_nothing_of_either_package(f):
    if not f.endswith(".py"):
        return
    tops = {m.split(".")[0] for m in _imports(
        os.path.join(ROOT, "bench", "reference", f))}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    assert tops <= {"__future__", "torch", "numpy", "math", "bench"}
