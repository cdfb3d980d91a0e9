"""Rate control (C17): per-frame QP adaptation toward a target bitrate.

Lambda-domain-flavored controller in its simplest robust form: a
proportional-integral loop on the bits error, stepping the slice QP
within [qp0 - span, qp0 + span].  The x266t slice header already carries
an independent QP, so the decoder needs nothing new; on the encoder each
distinct QP lazily compiles its device step once (persisted by the
compilation cache), which bounds compile cost to the small QP set.

This is the "matched bitrate" instrument (BASELINE.json:2,5): encode a
clip at a target and compare PSNR against a fixed-QP reference run.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RateControlState:
    target_bits_per_frame: float
    qp: int
    qp_min: int
    qp_max: int
    error_acc: float = 0.0       # integral of (actual - target)

    def update(self, actual_bits: int) -> int:
        """Record a coded frame; returns the QP for the next frame.

        ~6 QP steps double the bitrate [STD lambda model], so the
        proportional term maps log2(bits ratio) to QP steps.
        """
        import math

        err = actual_bits - self.target_bits_per_frame
        self.error_acc += err
        ratio = max(actual_bits, 1.0) / self.target_bits_per_frame
        p_term = 3.0 * math.log2(ratio)
        i_term = 2.0 * self.error_acc / max(
            self.target_bits_per_frame * 8.0, 1.0)
        new_qp = self.qp + int(round(
            max(-2.0, min(2.0, p_term * 0.5 + i_term))))
        self.qp = max(self.qp_min, min(self.qp_max, new_qp))
        return self.qp


def make_controller(cfg, bitrate_kbps: float, fps: float,
                    span: int = 6) -> RateControlState:
    target = bitrate_kbps * 1000.0 / max(fps, 1e-9)
    return RateControlState(
        target_bits_per_frame=target, qp=cfg.qp,
        qp_min=max(0, cfg.qp - span), qp_max=min(51, cfg.qp + span))


# ---- lambda-domain rate control (C17) --------------------------------------

# QP = A * ln(lambda) + B — the HM R-lambda mapping constants; the
# inverse of config.lambda_mode's lambda(QP) = 0.57 * 2^((QP-12)/3) is
# QP = 3/ln2 * ln(lambda/0.57) + 12 = 4.3281*ln(lambda) + 14.4295, so
# the loop's lambda and the encoder's mode-decision lambda agree.
_LQP_A = 3.0 / 0.6931471805599453
_LQP_B = 12.0 - _LQP_A * (-0.5621189181535413)   # ln(0.57)


@dataclass
class _RlModel:
    """Per-slice-type R-lambda model state: lambda = alpha * bpp^beta."""
    alpha: float = 3.2
    beta: float = -1.367

    def lam(self, bpp: float) -> float:
        import math

        return self.alpha * math.pow(max(bpp, 1e-7), self.beta)

    def update(self, lam_used: float, bpp_actual: float) -> None:
        """Gradient step so ln(lam) = ln(alpha) + beta*ln(bpp) tracks
        the observed (lam_used, bpp_actual) pair (HM delta rules)."""
        import math

        lb = math.log(max(bpp_actual, 1e-7))
        err = math.log(lam_used) - (math.log(self.alpha)
                                    + self.beta * lb)
        self.alpha *= math.exp(0.10 * err)
        self.beta += 0.05 * err * lb
        self.alpha = min(max(self.alpha, 0.05), 500.0)
        self.beta = min(max(self.beta, -3.0), -0.1)


class LambdaRateControl:
    """Frame-level lambda-domain rate control (C17, HM R-lambda shaped).

    Allocation: the remaining bit budget spreads over remaining frames
    with intra frames weighted `i_weight` (they cost several P frames'
    bits).  Per frame: bpp target -> lambda via the slice-type R-lambda
    model -> QP via the ln-lambda mapping (the exact inverse of
    config.lambda_mode, so mode decision optimizes the loop's lambda).
    After coding, the model adapts multiplicatively; per-frame QP moves
    are clamped to +-3 (+-5 across slice types) for visual stability.

    Drop-in compatible with RateControlState (`qp` attr + `update()`),
    so Encoder/CLI need no changes beyond construction.
    """

    def __init__(self, cfg, bitrate_kbps: float, fps: float,
                 n_frames: int | None = None, i_weight: float = 4.0):
        self.pixels = cfg.width * cfg.height
        self.target_bpf = bitrate_kbps * 1000.0 / max(fps, 1e-9)
        self.intra_period = max(cfg.intra_period, 1)
        self.i_weight = i_weight
        self.window = (n_frames if n_frames is not None
                       else 4 * self.intra_period)
        self.budget = self.target_bpf * self.window
        self.remaining = self.window
        self.models = {"I": _RlModel(alpha=6.5), "P": _RlModel()}
        self.qp = cfg.qp
        # Bound the excursion around the configured QP: every distinct QP
        # compiles a fresh device step, so an unbounded roam (1..51) can
        # spend most wall-clock recompiling on long bitrate encodes.
        # Targets more than ~2.5x away from cfg.qp's natural rate are
        # therefore unreachable; a one-time warning fires when the
        # controller saturates (below) so callers see it.
        self.qp_min = max(1, cfg.qp - 8)
        self.qp_max = min(51, cfg.qp + 8)
        self._sat_frames = 0
        self._warned = False
        self._poc = 0
        self._pending: tuple[str, float, int] | None = None

    def _kind(self) -> str:
        return "I" if self._poc % self.intra_period == 0 else "P"

    def _weight(self, kind: str) -> float:
        return self.i_weight if kind == "I" else 1.0

    def _alloc_bits(self, kind: str) -> float:
        """Weighted share of the remaining window budget."""
        n_rem = max(self.remaining, 1)
        # how many of the remaining slots are intra (approximate by
        # the steady-state rate 1/intra_period)
        n_i = max(round(n_rem / self.intra_period), 1 if kind == "I"
                  else 0)
        total_w = n_i * self.i_weight + (n_rem - n_i)
        # Floor the PER-FRAME share (not the window budget): after a large
        # overspend the raw share collapses toward zero, driving QP to the
        # max until the window rolls — floor it for graceful degradation.
        share = self.budget * self._weight(kind) / max(total_w, 1e-9)
        return max(share, 0.1 * self.target_bpf)

    def start_frame(self) -> int:
        """QP for the next frame (also stored in .qp)."""
        import math

        kind = self._kind()
        bits = self._alloc_bits(kind)
        lam = self.models[kind].lam(bits / self.pixels)
        qp = int(round(_LQP_A * math.log(lam) + _LQP_B))
        prev = self.qp
        span = 5 if kind == "I" else 3
        want = qp
        qp = min(max(qp, prev - span), prev + span)
        qp = min(max(qp, self.qp_min), self.qp_max)
        if want > self.qp_max or want < self.qp_min:
            self._sat_frames += 1
            if self._sat_frames >= 8 and not self._warned:
                import warnings

                warnings.warn(
                    f"LambdaRateControl saturated at QP "
                    f"[{self.qp_min}, {self.qp_max}] for "
                    f"{self._sat_frames} frames (model wants "
                    f"{want}): the bitrate target is outside the "
                    f"bounded excursion around cfg.qp; raise/lower "
                    f"cfg.qp toward the target's natural QP",
                    RuntimeWarning, stacklevel=2)
                self._warned = True
        else:
            self._sat_frames = 0
        self.qp = qp
        lam_used = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        self._pending = (kind, lam_used, qp)
        return qp

    def update(self, actual_bits: int) -> int:
        """Record the coded frame's bits; returns the next frame's QP."""
        if self._pending is None:          # encoder asked .qp directly
            self.start_frame()
        kind, lam_used, _ = self._pending
        self._pending = None
        self.models[kind].update(lam_used, actual_bits / self.pixels)
        self.budget -= actual_bits
        self.remaining -= 1
        self._poc += 1
        if self.remaining <= 0:            # roll the window forward
            self.budget += self.target_bpf * self.window
            self.remaining = self.window
        return self.start_frame()


def make_lambda_controller(cfg, bitrate_kbps: float, fps: float,
                           n_frames: int | None = None
                           ) -> LambdaRateControl:
    rc = LambdaRateControl(cfg, bitrate_kbps, fps, n_frames)
    rc.start_frame()
    return rc
