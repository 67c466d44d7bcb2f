"""The port imports neither JAX nor the reference package.

Shown in a subprocess: the root conftest already imports ``repro`` (and
with it ``jax``) into this process.
"""
import glob
import os
import pkgutil
import subprocess
import sys

_ROOT = os.path.join(os.path.dirname(__file__), "..")
_SRC = os.path.join(_ROOT, "src")


def _port_modules() -> list[str]:
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return sorted(names)


def test_port_module_list_covers_the_slice():
    names = set(_port_modules())
    for want in ("repro_torch.device", "repro_torch.core.graph",
                 "repro_torch.core.metrics", "repro_torch.core.partitioner",
                 "repro_torch.core.codecs", "repro_torch.models.cnn",
                 "repro_torch.kernels.ref", "repro_torch.kernels.block_quant",
                 "repro_torch.kernels.ops", "repro_torch.kernels._build",
                 "repro_torch.kernels.decode_attention",
                 "repro_torch.models.layers", "repro_torch.models.attention",
                 "repro_torch.models.lm_graph",
                 "repro_torch.kernels.ssd_scan", "repro_torch.models.ssm",
                 "repro_torch.models.transformer",
                 "repro_torch.configs.base", "repro_torch.configs.registry",
                 "repro_torch.configs.mamba2_2_7b",
                 "repro_torch.configs.zamba2_2_7b",
                 "repro_torch.runtime.wire", "repro_torch.runtime.transport",
                 "repro_torch.runtime.session", "repro_torch.runtime.node",
                 "repro_torch.runtime.topology", "repro_torch.runtime.router",
                 "repro_torch.runtime.dispatcher",
                 "repro_torch.runtime.engine",
                 "repro_torch.runtime.controller",
                 "repro_torch.runtime.supervisor",
                 "repro_torch.runtime.worker",
                 "repro_torch.core.emulator",
                 "repro_torch.core.pipeline",
                 "repro_torch.core.pipeline_decode",
                 "repro_torch.launch", "repro_torch.launch.mesh",
                 "repro_torch.launch.serve", "repro_torch.models.moe",
                 "repro_torch.sharding", "repro_torch.core.pipeline_ep",
                 "repro_torch.train", "repro_torch.train.optimizer",
                 "repro_torch.train.loop", "repro_torch.train.checkpoint",
                 "repro_torch.data", "repro_torch.data.pipeline",
                 "repro_torch.launch.steps", "repro_torch.launch.train"):
        assert want in names, want


def _import_blocked(mods: list[str], pythonpath: str) -> None:
    """Import ``mods`` in a fresh interpreter with ``jax`` and ``repro``
    blocked, and check that neither was pulled in."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if (m == 'jax' or m.startswith('jax.') or m == 'repro'\n"
        "                 or m.startswith('repro.')) and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('imported', len(" + repr(mods) + "))\n")
    env = dict(os.environ, PYTHONPATH=pythonpath)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=_ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(mods)}" in res.stdout


def test_every_port_module_imports_without_jax_or_repro():
    _import_blocked(_port_modules(), _SRC)


def test_port_benchmarks_import_without_jax_or_repro():
    """Every ``benchmarks/torch_*.py`` imports with ``jax`` and ``repro``
    blocked (its runner included), and pulls neither in."""
    mods = sorted("benchmarks." + os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(_ROOT, "benchmarks", "torch_*.py")))
    assert {"benchmarks.torch_common", "benchmarks.torch_run",
            "benchmarks.torch_fig2_throughput", "benchmarks.torch_fig3_energy",
            "benchmarks.torch_table1_codecs",
            "benchmarks.torch_table2_codec_throughput"} <= set(mods)
    _import_blocked(mods, os.pathsep.join([_SRC, _ROOT]))


def test_port_chaos_harness_imports_without_jax_or_repro():
    """``tools/torch_chaos.py``, the port's fault injector, imports with
    ``jax`` and ``repro`` blocked and pulls neither in."""
    _import_blocked(["tools.torch_chaos"], os.pathsep.join([_SRC, _ROOT]))
