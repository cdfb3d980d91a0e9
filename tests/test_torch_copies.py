"""The port's copies of the JAX package's jax-free modules stay the
reference's: each equals its original with the import lines rewritten
from ``x266_tpu`` to ``x266_tpu_torch`` and nothing else changed (text
comparison; it catches drift in either copy)."""

import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = [
    "config.py",
    "core/__init__.py", "core/bitio.py", "core/nal.py", "core/headers.py",
    "core/yuv.py", "core/hashing.py",
    "cabac/__init__.py", "cabac/contexts.py", "cabac/ctx_init.py",
    "cabac/engine.py", "cabac/syntax.py", "cabac/native_bind.py",
    "cabac/native/rangecoder.cpp",
    "specmodel/__init__.py", "specmodel/intra.py",
    "specmodel/transforms.py", "specmodel/quant.py",
    "specmodel/mip_tables.py",
    "utils/ratecontrol.py", "utils/metrics.py",
    "kernels/lfnst_tables.py",
]
IMPORT = re.compile(r"^(\s*)(from|import) x266_tpu([. ])", re.M)


def rewrite_imports(text: str) -> str:
    return IMPORT.sub(r"\1\2 x266_tpu_torch\3", text)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_reference_after_import_rewrite(rel):
    with open(os.path.join(ROOT, "x266_tpu", rel)) as f:
        want = rewrite_imports(f.read())
    with open(os.path.join(ROOT, "x266_tpu_torch", rel)) as f:
        got = f.read()
    assert got == want


def test_rewrite_touches_only_import_lines():
    text = ("from x266_tpu.config import A\n"
            "    from x266_tpu.specmodel.intra import B\n"
            "import x266_tpu.core\n"
            "doc mentioning x266_tpu.cabac stays\n")
    assert rewrite_imports(text) == (
        "from x266_tpu_torch.config import A\n"
        "    from x266_tpu_torch.specmodel.intra import B\n"
        "import x266_tpu_torch.core\n"
        "doc mentioning x266_tpu.cabac stays\n")


def _cli_flags(rel: str) -> set:
    """The option strings a command-line source declares (the quoted
    leading arguments of its add_argument calls)."""
    with open(os.path.join(ROOT, rel)) as f:
        calls = re.findall(r"add_argument\(([^)]*)\)", f.read())
    return set(re.findall(r'"(-{1,2}[a-z][a-z0-9-]*)"', " ".join(calls)))


def test_cli_takes_the_references_flags():
    """The port's command line (not a copy: it codes through the port's
    Encoder and Decoder) declares every flag of the reference's, and
    --device besides."""
    want = _cli_flags("x266_tpu/cli/main.py")
    assert len(want) > 40
    assert _cli_flags("x266_tpu_torch/cli/main.py") == want | {"--device"}
