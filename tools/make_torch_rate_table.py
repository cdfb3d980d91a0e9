"""Write the float32 rate surrogate tables of the PyTorch port.

The encoder's RD decisions (Pass A's rate estimate, RDOQ's level choice)
use rate(l) = 3 + 2*log2(l + 1) bits for a nonzero level l and 1/16 bit
for a zero (x266_tpu/kernels/cost.py, kernels/quant.py).  float32 ``log2``
differs between XLA and PyTorch in the last bit for thousands of integer
arguments, and RDOQ compares these rates to choose normative levels, so
the port reads them from a table evaluated once by JAX on the CPU.

The P-picture mode decision prices an explicit MV against its left
neighbour's with 2 + 2*log2(|d| + 1) bits per component
(x266_tpu/engine/inter.py:124-125); that term comes from a JAX-evaluated
table for the same reason.  |d| is at most 1152: both MVs are clipped to
+-(mv_bounds - 8) = +-280 quarter-pels (kernels/me.py:240), so
|d| <= 560; the table covers twice the mv_bounds reach for margin.

    python tools/make_torch_rate_table.py

Output: x266_tpu_torch/data/rate_f32.npy, float32[32768], index = |level|;
x266_tpu_torch/data/mvbits_f32.npy, float32[1153], index = |d|.
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

OUT = os.path.join(ROOT, "x266_tpu_torch", "data", "rate_f32.npy")
OUT_MV = os.path.join(ROOT, "x266_tpu_torch", "data", "mvbits_f32.npy")
N_LEVELS = 32768          # quantized levels are clipped to [0, 32767]
N_MVD = 1153              # |mv - mv_left| in quarter-pels, 0..1152


@jax.jit
def rate_of(levels):
    al = jnp.abs(levels).astype(jnp.float32)
    return jnp.where(al > 0, 3.0 + 2.0 * jnp.log2(al + 1.0), 0.0625)


@jax.jit
def mvbits_of(d):
    return 2.0 + 2.0 * jnp.log2(jnp.abs(d).astype(jnp.float32) + 1.0)


def table() -> np.ndarray:
    return np.asarray(rate_of(jnp.arange(N_LEVELS, dtype=jnp.int32)),
                      dtype=np.float32)


def mv_table() -> np.ndarray:
    return np.asarray(mvbits_of(jnp.arange(N_MVD, dtype=jnp.int32)),
                      dtype=np.float32)


def main() -> None:
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.save(OUT, table())
    np.save(OUT_MV, mv_table())
    print("wrote", OUT, OUT_MV)


if __name__ == "__main__":
    main()
