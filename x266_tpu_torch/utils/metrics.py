"""Structured metrics / observability (SURVEY.md §5).

Per-frame JSONL records with exactly the BASELINE.json:2 metric set
(bits, PSNR per plane, fps/chip) plus encoder decision histograms, and a
run summary.  Consumed by the CLI (--stats) and available as a callback
for embedding applications.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class FrameRecord:
    poc: int
    slice_type: str
    bits: int
    psnr_y: float
    psnr_cb: float
    psnr_cr: float
    enc_seconds: float
    size_histogram: dict = field(default_factory=dict)
    pred_histogram: dict = field(default_factory=dict)


class MetricsLog:
    def __init__(self, path: str | None = None):
        self.path = path
        self.records: list[FrameRecord] = []
        self._t0 = time.time()

    def add(self, rec: FrameRecord) -> None:
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec.__dict__) + "\n")

    def summary(self) -> dict:
        n = len(self.records)
        if not n:
            return {}
        dt = time.time() - self._t0
        out = {
            "frames": n,
            "total_bits": int(sum(r.bits for r in self.records)),
            "mean_psnr_y": float(np.mean(
                [r.psnr_y for r in self.records])),
            "fps": n / max(dt, 1e-9),
            "mean_bits_i": float(np.mean(
                [r.bits for r in self.records
                 if r.slice_type == "I"] or [0])),
            "mean_bits_p": float(np.mean(
                [r.bits for r in self.records
                 if r.slice_type == "P"] or [0])),
        }
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps({"summary": out}) + "\n")
        return out


def decision_histograms(size_map: np.ndarray,
                        pred_map: np.ndarray | None) -> tuple[dict, dict]:
    sizes, counts = np.unique(size_map, return_counts=True)
    size_h = {int(s): int(c) for s, c in zip(sizes, counts)}
    pred_h = {}
    if pred_map is not None:
        names = {0: "intra", 1: "inter", 2: "skip"}
        ks, cs = np.unique(pred_map, return_counts=True)
        pred_h = {names.get(int(k), str(int(k))): int(c)
                  for k, c in zip(ks, cs)}
    return size_h, pred_h
