"""The PyTorch port imports neither JAX nor the JAX package (it runs on a
host that has none, and keeps its own copies of the jax-free modules).

Checked in a subprocess with ``sys.modules['jax'] = None`` and
``sys.modules['x266_tpu'] = None``, because this test process imported
both already (tests/conftest.py and the other test files).  Exact: the
import either succeeds for every module or the test fails.
"""

import os
import pkgutil
import re
import subprocess
import sys

import x266_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(x266_tpu_torch.__file__)
SCRIPTS = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "tools", "profile_torch.py"),
           os.path.join(ROOT, "tools", "profile_recon.py"),
           os.path.join(ROOT, "tools", "profile_me.py"),
           os.path.join(ROOT, "tools", "profile_common.py")]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="x266_tpu_torch."))


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield from SCRIPTS


def test_port_imports_with_jax_blocked():
    mods = _modules()
    assert "x266_tpu_torch.engine.recon_cuda" in mods
    assert "x266_tpu_torch.kernels.me_cuda" in mods
    assert "x266_tpu_torch.utils.ratecontrol" in mods
    code = ("import sys; sys.modules['jax'] = None\n"
            "sys.modules['x266_tpu'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "sys.path.insert(0, 'tools')\n"
            "import profile_torch\n"
            "import profile_recon\n"
            "import profile_me\n"
            "bad = [k for k, v in sys.modules.items() if v and (\n"
            "       k.split('.')[0] in ('jax', 'x266_tpu'))]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    for path in _sources():
        with open(path) as f:
            for line in f:
                s = line.strip()
                assert not (s.startswith("import jax")
                            or s.startswith("from jax")), (path, s)


def test_port_sources_never_import_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+x266_tpu(\.|\s|$)")
    for path in _sources():
        with open(path) as f:
            for line in f:
                assert not pat.match(line), (path, line)
