"""JVT-G012 quadratic rate control (frame-level basic unit).

Algorithm port (not a code translation) of the reference rate controller
(lencod/src/ratectl.c rc_init_seq/rc_init_GOP/rc_init_pict and
lencod/src/rc_quadratic.c updateRCModel/RCModelEstimator/updateMADModel,
QP2Qstep/Qstep2QP at rc_quadratic.c:94/115): a quadratic R-D model
R = X1*MAD/Qstep + X2*MAD/Qstep^2 fit by outlier-rejecting least squares
over a sliding window, a linear MAD predictor, and a virtual-buffer
feedback term for the per-picture bit target.

This is sequential host-side control (SURVEY.md §2 "TPU target: host"):
it only picks a QP per picture; all pixel work stays on device.
"""

from __future__ import annotations

import numpy as np

_QSTEP0 = (0.625, 0.6875, 0.8125, 0.875, 1.0, 1.125)
_WINDOW = 20


def qp_to_qstep(qp: int) -> float:
    """QP2Qstep (rc_quadratic.c:94): Qstep doubles every 6 QP."""
    return _QSTEP0[qp % 6] * (1 << (qp // 6))


def qstep_to_qp(qstep: float) -> int:
    """Qstep2QP (rc_quadratic.c:115): nearest-QP inverse of QP2Qstep."""
    if qstep <= qp_to_qstep(0):
        return 0
    if qstep >= qp_to_qstep(51):
        return 51
    q = 0
    while qstep > _QSTEP0[5] + 1e-9 and q < 46:
        qstep /= 2.0
        q += 6
    i = min(range(6), key=lambda i: abs(_QSTEP0[i] - qstep))
    return min(51, q + i)


class RateControl:
    """Frame-level JVT-G012 controller.

    Usage per picture:
        qp = rc.pick_qp(kind)       # kind in "I" / "P" / "B"
        ... encode at qp ...
        rc.post_frame(kind, bits, mad)
    """

    def __init__(self, bit_rate: float, frame_rate: float, width: int,
                 height: int, gop_size: int = 0, n_b: int = 0,
                 min_qp: int = 0, max_qp: int = 51):
        self.bit_rate = float(bit_rate)
        self.frame_rate = float(frame_rate)
        self.npixels = width * height
        self.gop_size = gop_size  # 0: single open GOP to end of sequence
        self.n_b = n_b
        self.min_qp, self.max_qp = min_qp, max_qp
        self.bits_per_frame = self.bit_rate / self.frame_rate

        # initial QP from bpp thresholds (rc_init_seq; QCIF/CIF row of
        # the JM table: l1=0.15, l2=0.45, l3=0.9)
        bpp = self.bit_rate / (self.frame_rate * self.npixels)
        if bpp <= 0.15:
            qp0 = 35
        elif bpp <= 0.45:
            qp0 = 25
        elif bpp <= 0.9:
            qp0 = 20
        else:
            qp0 = 10
        self.qp0 = qp0
        self.prev_p_qp = qp0
        self.last_qp = qp0

        # quadratic R-D model state
        self.x1 = self.bit_rate
        self.x2 = 0.0
        # linear MAD prediction model
        self.mad_a1, self.mad_a2 = 1.0, 0.0
        self.prev_mad = 1.0
        # sliding windows: (mad, qstep, texture_bits) and (mad_prev, mad)
        self.rd_window: list[tuple[float, float, float]] = []
        self.mad_window: list[tuple[float, float]] = []

        # virtual buffer
        self.buffer_fullness = 0.0
        self.gamma = 0.5 if n_b == 0 else 0.25

        self.n_coded = 0
        self.p_qp_sum = 0
        self.p_count = 0
        self._last_target = self.bits_per_frame

    # ------------------------------------------------------------------
    def pick_qp(self, kind: str) -> int:
        if kind == "I":
            # rc_init_GOP-style: first I at qp0; later anchors track the
            # running average P QP of the previous GOP minus 1
            if self.p_count == 0:
                qp = self.qp0
            else:
                qp = int(round(self.p_qp_sum / self.p_count)) - 1
        elif kind == "B":
            # non-stored B: bridge QP between surrounding anchors (+2 for
            # a single B, +1..+2 taper otherwise — JM updateQPNonPicAFF)
            qp = self.prev_p_qp + 2
        else:
            qp = self._pick_p_qp()
        qp = int(np.clip(qp, self.min_qp, self.max_qp))
        if kind == "P":
            # JM smoothness clip: at most +-2 between consecutive P QPs
            qp = int(np.clip(qp, self.prev_p_qp - 2, self.prev_p_qp + 2))
            self.prev_p_qp = qp
            self.p_qp_sum += qp
            self.p_count += 1
        self.last_qp = qp
        return qp

    def _pick_p_qp(self) -> int:
        # target bits: per-frame budget corrected by buffer feedback
        # (rc_init_pict: T = bpf - gamma * buffer_fullness, floored)
        target = self.bits_per_frame - self.gamma * self.buffer_fullness
        target = max(target, self.bits_per_frame * 0.1)
        self._last_target = target

        mad = max(self.mad_a1 * self.prev_mad + self.mad_a2, 1e-3)
        # solve X1*MAD/Q + X2*MAD/Q^2 = T for Qstep (rc_handle_mb path)
        t = target
        if self.x2 == 0.0:
            qstep = self.x1 * mad / t
        else:
            a, b, c = t, -self.x1 * mad, -self.x2 * mad
            disc = b * b - 4 * a * c
            if disc < 0:
                qstep = self.x1 * mad / t
            else:
                qstep = (-b + np.sqrt(disc)) / (2 * a)
                if qstep <= 0:
                    qstep = self.x1 * mad / t
        return qstep_to_qp(float(qstep))

    # ------------------------------------------------------------------
    def post_frame(self, kind: str, bits: float, mad: float):
        """Feed back actual bits and measured MAD after coding a frame."""
        self.buffer_fullness += bits - self.bits_per_frame
        self.n_coded += 1
        if kind != "P":
            return
        mad = max(float(mad), 1e-3)
        qstep = qp_to_qstep(self.last_qp)
        self.rd_window.append((mad, qstep, float(bits)))
        if len(self.rd_window) > _WINDOW:
            self.rd_window.pop(0)
        self.mad_window.append((self.prev_mad, mad))
        if len(self.mad_window) > _WINDOW:
            self.mad_window.pop(0)
        self.prev_mad = mad
        self._fit_rd_model()
        self._fit_mad_model()

    # -- model estimation (RCModelEstimator rc_quadratic.c:1033) ---------
    def _fit_rd_model(self):
        pts = self.rd_window
        for _ in range(2):  # one outlier-rejection pass
            if len(pts) < 2:
                if pts:
                    m, q, r = pts[-1]
                    self.x1 = r * q / m
                    self.x2 = 0.0
                return
            # LLS on r*q/m = x1 + x2/q  (divide through by MAD/Qstep)
            A = np.array([[1.0, 1.0 / q] for m, q, r in pts])
            y = np.array([r * q / m for m, q, r in pts])
            sol, *_ = np.linalg.lstsq(A, y, rcond=None)
            self.x1, self.x2 = float(sol[0]), float(sol[1])
            # reject points with error > 1 std
            pred = A @ sol
            err = np.abs(pred - y)
            if len(pts) > 4 and err.std() > 0:
                keep = err <= err.std()
                if keep.sum() >= 2 and keep.sum() < len(pts):
                    pts = [p for p, k in zip(pts, keep) if k]
                    continue
            break

    def _fit_mad_model(self):
        pts = self.mad_window
        if len(pts) < 2:
            self.mad_a1, self.mad_a2 = 1.0, 0.0
            return
        A = np.array([[p, 1.0] for p, c in pts])
        y = np.array([c for p, c in pts])
        sol, *_ = np.linalg.lstsq(A, y, rcond=None)
        self.mad_a1, self.mad_a2 = float(sol[0]), float(sol[1])
