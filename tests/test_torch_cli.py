"""The port's command line (x266_tpu_torch.cli) against the JAX package's
(x266_tpu.cli), both called in this process on the CPU: ``encode`` of a
96x64 raw clip of 3 frames with --profile vvc --cclm --gop 2 --deblock
(an I, a P and an I picture) writes the same bytes and prints the same
per-frame lines and --stats records (the frame rate aside), ``decode``
prints the same MD5 lines and writes the same YUV, ``stats`` prints the
same lines; --sharded and tiles raise NotImplementedError, and without a
card the default --device cuda fails rather than coding on the CPU.
Exact comparisons throughout.
"""

import contextlib
import io
import json

import pytest
import torch

from x266_tpu.cli.main import main as jax_main
from x266_tpu_torch.cli.main import main as port_main
from x266_tpu_torch.core.yuv import synthetic_clip, write_yuv420
from x266_tpu_torch.utils.clips import luma_chroma

torch.set_num_threads(1)

FLAGS = ["-s", "96x64", "--profile", "vvc", "--cclm", "--gop", "2",
         "--deblock"]


def _run(main, argv):
    """main(argv) -> (exit code, the lines it printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main(argv)
    return code, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def coded(tmp_path_factory):
    """The clip, and each CLI's encode of it: {"jax"|"port": (stream,
    printed lines, stats records)}."""
    d = tmp_path_factory.mktemp("cli")
    yuv = d / "in.yuv"
    write_yuv420(str(yuv), luma_chroma(synthetic_clip(96, 64, 3, "mixed",
                                                      seed=2)))
    out = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        bit, stats = d / f"{name}.266t", d / f"{name}.jsonl"
        code, lines = _run(main, ["encode", "-i", str(yuv), "-o", str(bit),
                                  *FLAGS, "--stats", str(stats), *extra])
        assert code == 0
        with open(stats) as f:
            records = [json.loads(ln) for ln in f]
        out[name] = (bit.read_bytes(), lines, records)
    return d, yuv, out


def test_encode_writes_the_jax_clis_bytes(coded):
    _, _, out = coded
    assert out["port"][0] == out["jax"][0]
    # per-frame lines equal; the summary's frame rate is the run's own
    pl, jl = out["port"][1], out["jax"][1]
    assert len(pl) == len(jl) == 4
    assert pl[:3] == jl[:3]
    assert pl[3].rsplit(",", 1)[0] == jl[3].rsplit(",", 1)[0]
    pr, jr = out["port"][2], out["jax"][2]
    assert pr[:3] == jr[:3]
    for r in (pr[3]["summary"], jr[3]["summary"]):
        r.pop("fps")
    assert pr[3] == jr[3]


def test_decode_prints_the_jax_clis_md5_lines(coded):
    d, _, out = coded
    bit = d / "port.266t"
    _, jl = _run(jax_main, ["decode", "-i", str(bit), "-o",
                            str(d / "jax_dec.yuv")])
    code, pl = _run(port_main, ["decode", "-i", str(bit), "-o",
                                str(d / "port_dec.yuv"), "--device", "cpu"])
    assert code == 0
    md5 = [ln for ln in pl if ln.startswith("POC")]
    assert len(md5) == 3 and md5 == [ln for ln in jl
                                     if ln.startswith("POC")]
    assert ((d / "port_dec.yuv").read_bytes()
            == (d / "jax_dec.yuv").read_bytes())


def test_stats_prints_the_jax_clis_lines(coded):
    d, _, _ = coded
    argv = ["stats", "-i", str(d / "port.266t")]
    code, pl = _run(port_main, argv)
    assert code == 0
    assert pl == _run(jax_main, argv)[1]
    assert any("cclm" in ln for ln in pl)


@pytest.mark.parametrize("extra", [["--sharded"], ["--tile-rows", "1"],
                                   ["--tile-cols", "1"]],
                         ids=["sharded", "tile-rows", "tile-cols"])
def test_outside_the_slices_raises(extra, tmp_path):
    """On a 96x128 clip (two CTU rows and columns) one CTU row or column
    a tile makes two tiles."""
    yuv = tmp_path / "in.yuv"
    write_yuv420(str(yuv), synthetic_clip(96, 128, 1, "mixed", seed=2))
    with pytest.raises(NotImplementedError):
        port_main(["encode", "-i", str(yuv), "-o", str(tmp_path / "x.266t"),
                   "-s", "96x128", *FLAGS[2:], "--device", "cpu", *extra])


def test_default_device_needs_a_card(coded, monkeypatch):
    """--device defaults to cuda; without a card encode and decode fail
    as Encoder() and Decoder() do, and never code on the CPU."""
    d, yuv, _ = coded
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_main(["encode", "-i", str(yuv), "-o", str(d / "y.266t"),
                   *FLAGS])
    with pytest.raises(RuntimeError, match="cuda"):
        port_main(["decode", "-i", str(d / "port.266t"), "-o",
                   str(d / "y.yuv")])


def test_version_prints_the_package_version():
    import x266_tpu_torch

    assert _run(port_main, ["version"]) == (
        0, [f"x266t {x266_tpu_torch.__version__}"])
