"""The PyTorch port imports without JAX (it runs on a host that has none).

Checked in a subprocess with ``sys.modules['jax'] = None``, because this
test process imported jax already (tests/conftest.py).  Exact: the
import either succeeds for every module or the test fails.
"""

import os
import pkgutil
import subprocess
import sys

import x266_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(x266_tpu_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="x266_tpu_torch."))


def test_port_imports_with_jax_blocked():
    mods = _modules()
    assert "x266_tpu_torch.engine.recon_cuda" in mods
    code = ("import sys; sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "assert not any(k == 'jax' or k.startswith('jax.')\n"
            "               for k, v in sys.modules.items() if v)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                for line in f:
                    s = line.strip()
                    assert not (s.startswith("import jax")
                                or s.startswith("from jax")), (name, s)
