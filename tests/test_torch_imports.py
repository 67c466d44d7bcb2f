"""The port imports neither JAX nor the reference package.

Shown in a subprocess: the root conftest already imports ``repro`` (and
with it ``jax``) into this process.
"""
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
                 "repro_torch.runtime.wire", "repro_torch.runtime.transport",
                 "repro_torch.runtime.session", "repro_torch.runtime.node",
                 "repro_torch.runtime.topology", "repro_torch.runtime.router",
                 "repro_torch.runtime.dispatcher",
                 "repro_torch.runtime.engine"):
        assert want in names, want


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
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
    env = dict(os.environ, PYTHONPATH=_SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=_ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(mods)}" in res.stdout
