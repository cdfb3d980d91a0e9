"""Write the JAX reference results that the PyTorch port is held to on a
machine without JAX.

Encodes frames 0-3 of the config-2 main path (all-intra 1080p VVC,
``preset_cfg2`` + one entropy segment per CTU row + WPP context
inheritance, the ``bench.py`` headline configuration) with the JAX
package on the CPU, and records per frame the coded bits, the
device-accounted PSNR-Y, the MD5 of the slice NAL and the MD5 of the
reconstruction.  ``chip_smoke.py`` compares the port's encode of the same
frames against this file.

    python tools/make_torch_refs.py      # about a minute per frame

Output: x266_tpu_torch/data/cfg2_1080p_ref.json
"""
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from x266_tpu.api import Decoder, Encoder  # noqa: E402
from x266_tpu.config import preset_cfg2  # noqa: E402
from x266_tpu.core.hashing import frame_md5  # noqa: E402
from x266_tpu.core.nal import NalType, split_nals, write_nal  # noqa: E402
from x266_tpu.core.yuv import synthetic_clip  # noqa: E402

W, H, N = 1920, 1080, 4
OUT = os.path.join(ROOT, "x266_tpu_torch", "data", "cfg2_1080p_ref.json")


def slice_nal_md5s(stream: bytes) -> list[str]:
    return [hashlib.md5(write_nal(t, rbsp)).hexdigest()
            for t, rbsp in split_nals(stream)
            if t in (NalType.IDR, NalType.TRAIL)]


def main() -> None:
    cfg = preset_cfg2(W, H).replace(rows_per_segment=1, ctx_inherit=True)
    frames = synthetic_clip(W, H, N, "mixed")
    t0 = time.time()
    res = Encoder(cfg, with_recon=True).encode(frames)
    secs = time.time() - t0
    _, dec = Decoder().decode(res.bitstream)
    assert [frame_md5(d) for d in dec] == [frame_md5(r)
                                           for r in res.recon]
    out = {
        "source": "x266_tpu (JAX, CPU backend), tools/make_torch_refs.py",
        "config": "preset_cfg2(1920, 1080).replace(rows_per_segment=1, "
                  "ctx_inherit=True)",
        "clip": "synthetic_clip(1920, 1080, 4, 'mixed')",
        "stream_md5": hashlib.md5(res.bitstream).hexdigest(),
        "frames": [
            {"poc": i, "bits": int(b), "psnr_y": float(p),
             "nal_md5": n, "recon_md5": frame_md5(r)}
            for i, (b, p, n, r) in enumerate(zip(
                res.frame_bits, res.psnr_y(W, H),
                slice_nal_md5s(res.bitstream), res.recon))],
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["frames"]))
    print(f"wrote {OUT} ({secs:.0f} s to encode)")


if __name__ == "__main__":
    main()
