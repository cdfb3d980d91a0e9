"""Sample-adaptive offset (C14), as x266_tpu/kernels/sao.py.

Per CTB: a type (off, edge class 0-3 or band), four offsets and a band
position.  ``apply_sao`` is normative and integer: it computes the four
edge-class category maps of the whole plane and selects per sample
through the CTB parameter planes.

``estimate_sao`` is the encoder's choice, in float32 as the reference
makes it, and gives the reference's parameters exactly:
- each per-CTB masked sum of (orig - recon) or of a mask is an integer
  below 4096 * 255 < 2^24, so summing it exactly (int64) and rounding
  once to float32 equals the reference's float32 block sum;
- the means, ``round`` (half to even in both libraries) and the gain
  terms are single IEEE float32 operations on those values;
- the two sums the reference accumulates in a fixed order -- the edge
  gain over categories 1-4 in turn, and each band window's four gains
  added left to right (``_window4``) -- keep that order.  At 8 bits
  their terms are integers whose magnitudes add up to less than
  49 * 4096 + 14 * 4096 * 255 < 2^24, so any order gives the same
  float32 sum; from 10 bits on the order would matter.
"""

from __future__ import annotations

import numpy as np
import torch

SAO_OFF = 0
SAO_EO0 = 1
SAO_BAND = 5
MAX_OFFSET = 7

_EDGE_NEIGHBORS = [((0, -1), (0, 1)),
                   ((-1, 0), (1, 0)),
                   ((-1, -1), (1, 1)),
                   ((-1, 1), (1, -1))]


def _category_maps(y: torch.Tensor) -> torch.Tensor:
    """(4, H, W) int32 edge categories 0-4 per class; samples whose
    neighbour lies outside the picture get category 0."""
    h, w = y.shape
    yi = y.to(torch.int32)
    ys = torch.arange(h, device=y.device)[:, None]
    xs = torch.arange(w, device=y.device)[None, :]
    cats = []
    for d0, d1 in _EDGE_NEIGHBORS:
        n0 = torch.roll(yi, (-d0[0], -d0[1]), (0, 1))
        n1 = torch.roll(yi, (-d1[0], -d1[1]), (0, 1))
        s = torch.sign(yi - n0) + torch.sign(yi - n1)
        cat = torch.zeros_like(yi)
        for val, c in ((-2, 1), (-1, 2), (1, 3), (2, 4)):
            cat = torch.where(s == val, c, cat)
        valid = torch.ones((h, w), dtype=torch.bool, device=y.device)
        for dy, dx in (d0, d1):
            valid &= ((ys + dy >= 0) & (ys + dy < h)
                      & (xs + dx >= 0) & (xs + dx < w))
        cats.append(torch.where(valid, cat, 0))
    return torch.stack(cats)


def _upsample_ctb(param: torch.Tensor, h: int, w: int, ctb: int):
    return param.repeat_interleave(ctb, 0).repeat_interleave(
        ctb, 1)[:h, :w]


def apply_sao(y, sao_type, sao_band, sao_off, ctb: int = 64,
              bit_depth: int = 8) -> torch.Tensor:
    """Per-CTB SAO on one plane (luma ctb 64, chroma 32; the parameter
    grid is the luma CTU grid).  y (H, W) int32; sao_type / sao_band
    (Cy, Cx); sao_off (Cy, Cx, 4) signed offsets."""
    h, w = y.shape
    cats = _category_maps(y)
    type_p = _upsample_ctb(sao_type, h, w, ctb)
    band_p = _upsample_ctb(sao_band, h, w, ctb)
    offs_p = [_upsample_ctb(sao_off[..., i], h, w, ctb) for i in range(4)]
    is_edge = (type_p >= SAO_EO0) & (type_p <= SAO_EO0 + 3)
    cls = (type_p - SAO_EO0).clamp(0, 3)
    cat = torch.zeros_like(y)
    for c in range(4):
        cat = torch.where(cls == c, cats[c], cat)
    edge_off = torch.zeros_like(y)
    for i in range(4):
        edge_off = torch.where(cat == i + 1, offs_p[i], edge_off)
    edge_off = torch.where(is_edge & (cat > 0), edge_off, 0)
    rel = (y >> (bit_depth - 5)) - band_p
    band_off = torch.zeros_like(y)
    for i in range(4):
        band_off = torch.where(rel == i, offs_p[i], band_off)
    band_off = torch.where(type_p == SAO_BAND, band_off, 0)
    return (y + edge_off + band_off).clamp(0, (1 << bit_depth) - 1)


def _ctb_bins(labels: torch.Tensor, n_labels: int, ctb: int, cy: int,
              cx: int, weights=None) -> torch.Tensor:
    """Per (label, CTB) sums of weights (or counts): (n_labels, Cy, Cx)
    float32, exact (every sum is an integer below 2^24, summed in
    int32).  A one-hot per-CTB reduction, not a histogram: CUDA's
    histogram reads its size back to the host."""
    h, w = labels.shape
    pad = (0, cx * ctb - w, 0, cy * ctb - h)
    lab = torch.nn.functional.pad(labels.to(torch.int32), pad, value=-1)
    hot = lab[None] == torch.arange(n_labels, dtype=torch.int32,
                                    device=lab.device)[:, None, None]
    if weights is not None:
        hot = hot * torch.nn.functional.pad(weights.to(torch.int32), pad)
    return hot.reshape(n_labels, cy, ctb, cx, ctb).sum(
        (2, 4), dtype=torch.int32).to(torch.float32)


def _window4(g: torch.Tensor) -> torch.Tensor:
    """gain_b[p:p+4].sum(0) for p = 0..28 in the reference's order:
    ((g[p] + g[p+1]) + g[p+2]) + g[p+3]."""
    return ((g[0:29] + g[1:30]) + g[2:31]) + g[3:32]


def estimate_sao(orig, recon, lam: float, ctb: int = 64,
                 bit_depth: int = 8):
    """The per-CTB SAO parameters minimizing D + lambda * R: (sao_type,
    sao_band, sao_off) int32, those of the reference."""
    orig = orig.to(torch.int32)
    recon = recon.to(torch.int32)
    h, w = orig.shape
    cy, cx = -(-h // ctb), -(-w // ctb)
    diff = orig - recon
    cats = _category_maps(recon)
    f32 = torch.float32

    def c32(v):
        """v rounded to float32, as a scalar operand of float32 ops."""
        return float(np.float32(v))

    edge_costs, edge_offsets = [], []
    for c in range(4):
        e_all = _ctb_bins(cats[c], 5, ctb, cy, cx, diff)
        n_all = _ctb_bins(cats[c], 5, ctb, cy, cx)
        gain = torch.zeros((cy, cx), dtype=f32, device=orig.device)
        offs = []
        for cat in range(1, 5):
            e, n = e_all[cat], n_all[cat]
            mean = torch.where(n > 0, e / torch.clamp(n, min=1), c32(0))
            sgn = c32(1.0 if cat <= 2 else -1.0)
            mag = torch.round(mean * sgn).clamp(0, MAX_OFFSET)
            off = mag * sgn
            gain = gain + (n * off * off - c32(2.0) * off * e)
            offs.append(off.to(torch.int32))
        edge_costs.append(gain + c32(lam * 12.0))
        edge_offsets.append(torch.stack(offs, dim=-1))

    band = recon >> (bit_depth - 5)
    e_b = _ctb_bins(band, 32, ctb, cy, cx, diff)
    n_b = _ctb_bins(band, 32, ctb, cy, cx)
    mean_b = torch.where(n_b > 0, e_b / torch.clamp(n_b, min=1), c32(0))
    off_b = torch.round(mean_b).clamp(-MAX_OFFSET, MAX_OFFSET)
    gain_b = n_b * off_b * off_b - c32(2.0) * off_b * e_b
    win = _window4(gain_b)
    best_pos = torch.argmin(win, dim=0)
    band_cost = win.amin(dim=0) + c32(lam * 16.0)
    band_offs = torch.stack(
        [torch.gather(off_b, 0, (best_pos + i)[None])[0] for i in range(4)],
        dim=-1).to(torch.int32)

    all_costs = torch.stack([torch.full((cy, cx), float(np.float32(
        lam * 2.0)), dtype=f32, device=orig.device)] + edge_costs
        + [band_cost])
    choice = torch.argmin(all_costs, dim=0)
    sao_type = choice.to(torch.int32)
    sao_band = torch.where(choice == 5, best_pos, 0).to(torch.int32)
    all_offs = torch.stack([torch.zeros((cy, cx, 4), dtype=torch.int32,
                                        device=orig.device)]
                           + edge_offsets + [band_offs])
    sao_off = torch.gather(all_offs, 0,
                           choice[None, ..., None].expand(1, cy, cx, 4))[0]
    return sao_type, sao_band, sao_off
