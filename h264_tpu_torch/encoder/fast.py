"""The legacy P16x16 P picture (``rd=False``): motion search, quarter-pel
refinement, residual coding and reconstruction of every MB as one 16x16
partition, then the in-loop filter and the next reference, on the card.

The PyTorch counterpart of the reference package's encoder/fast.py (its
``p_frame_pipeline``, one jitted program per picture).  Per picture:
  1. the integer-pel SSD of every MB at every offset in [-R, R]^2 plus the
     MV-rate prior ``_lam_cost(lambda_me, bits)`` around the zero vector,
     first minimum in (dy, dx) order (kernel K12, ``csrc/p16_search.cu``);
  2. the 49 quarter-pel candidates around it from the padded plane and its
     half-pel planes b, h and j, SSD plus rate, first minimum; the luma
     4x4 transform, inter quantization, dequantization and recon; the
     chroma 1/8-pel prediction, 4x4 transform with the 2x2 DC Hadamard,
     quantization and recon of U and V (kernel K13, ``csrc/p16_refine.cu``);
  3. the boundary strengths of an all-inter single-reference picture and
     the bS <= 2 filter (K6 ``strengths`` and ``deblock``: with no intra
     block and one reference their rules are the reference's
     ``strengths_device_p`` and ``deblock_device_p``);
  4. the next reference: the padded planes and the 6-tap half-pel planes
     (K2 ``ref_bank``, whose bank holds b, h and j shifted by 2 samples).
The reference's ``stack_outputs`` (fast.py:86) is the encoder's
``fetch_group``: a group's flat outputs in one copy to the host.

Each device function has its plain PyTorch version here; ``p_frame_core``
(``p_frame_device``) and ``p_frame_pipeline`` go through the kernel wrappers
(``LKernels``), which run the plain versions on CPU tensors and launch the
kernels on CUDA ones.  Every window stays inside its padded plane at
R <= 28 (the encoder's clamp); the plain versions place windows as the
reference's ``dynamic_slice`` does all the same.  The reference's "int64"
casts run as int32 there (JAX without x64), and so in int32 here.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from ..ops import quant as Q
from ..ops import transforms as TR
from .rd import _bank_from_pad, _lam_cost, ref_entry_plain
from .rd import _mv_bits as mv_bits
from .rd_b import _slice_start
from .rd_p import deblock_plain
from .strengths import strengths_plain

PAD = 32
I32 = torch.int32
# the refinement's 49 quarter-pel offsets (dx, dy), dy outer
_REFINE = [(dx, dy) for dy in range(-3, 4) for dx in range(-3, 4)]


def _blocks(x, n: int):
    """(H, W) -> (H/n, W/n, n, n) blocks."""
    H, W = x.shape
    return x.reshape(H // n, n, W // n, n).transpose(1, 2)


def _unblock(b):
    """(Hb, Wb, n, n) blocks -> (Hb n, Wb n) plane."""
    Hb, Wb, n, _ = b.shape
    return b.transpose(1, 2).reshape(Hb * n, Wb * n)


def _mb_origins(H: int, W: int, dev):
    n_mx = W // 16
    i = torch.arange((H // 16) * n_mx, device=dev)
    return (i // n_mx) * 16, (i % n_mx) * 16


def _window(plane, ys, xs, size: int):
    """(n, size, size) windows of `plane` at starts (ys, xs), each placed
    as ``dynamic_slice`` places it."""
    L0, L1 = plane.shape
    a = torch.arange(size, device=plane.device)
    iy = _slice_start(ys, L0, size)[:, None] + a
    ix = _slice_start(xs, L1, size)[:, None] + a
    return plane[iy[:, :, None], ix[:, None, :]]


# ---------------------------------------------------------------------------
# plain versions of the device functions
# ---------------------------------------------------------------------------

def search_plain(cur_y, ref_pad, R: int, lambda_me: int):
    """Integer-pel search (fast.py:117-158): cur_y (H, W), ref_pad
    (H+64, W+64) int32 -> (int_mvx, int_mvy, grid0) (n_my, n_mx) int32,
    grid0 the SSD at the zero offset.  The reference forms the SSD in
    float32 from exact integer terms below 2^24, so the integer SSD equals
    it."""
    H, W = cur_y.shape
    if not 0 <= R <= PAD:
        raise ValueError(f"search range {R} outside 0..{PAD}")
    D = 2 * R + 1
    n_my, n_mx = H // 16, W // 16
    refw = ref_pad[PAD - R: PAD + H + R, PAD - R: PAD + W + R]
    ssd = torch.empty((D, D, n_my, n_mx), dtype=I32, device=cur_y.device)
    for dy in range(D):
        strip = refw[dy: dy + H]
        e = cur_y[None] - torch.stack([strip[:, dx: dx + W]
                                       for dx in range(D)])
        ssd[dy] = (e * e).reshape(D, n_my, 16, n_mx, 16).sum(
            (2, 4), dtype=I32)
    bits = mv_bits(torch.arange(-R, R + 1, device=cur_y.device,
                                dtype=I32) * 4)
    rate = _lam_cost(int(lambda_me), bits[:, None] + bits[None, :])
    cost = ssd + rate[..., None, None]
    best = cost.reshape(D * D, n_my, n_mx).argmin(0).to(I32)
    return best % D - R, best // D - R, ssd[R, R].clone()


def qpel_window(planes, iy, ix, dx: int, dy: int):
    """(n, 16, 16) quarter-pel prediction windows at padded integer
    positions (iy, ix) with the static fraction (dx, dy) (fast.py:166-192):
    planes = (ref_pad, b, h, j), b/h/j 5 samples smaller than ref_pad and
    indexed 2 samples up and left of it."""
    ref_pad, bpl, hpl, jpl = planes

    def G(oy, ox):
        return _window(ref_pad, iy + oy, ix + ox, 16)

    def B(oy, ox):
        return _window(bpl, iy - 2 + oy, ix - 2 + ox, 16)

    def Hh(oy, ox):
        return _window(hpl, iy - 2 + oy, ix - 2 + ox, 16)

    def J(oy, ox):
        return _window(jpl, iy - 2 + oy, ix - 2 + ox, 16)

    def avg(p, q):
        return (p + q + 1) >> 1

    if (dx, dy) == (0, 0):
        return G(0, 0)
    if dy == 0:
        return {1: lambda: avg(G(0, 0), B(0, 0)), 2: lambda: B(0, 0),
                3: lambda: avg(B(0, 0), G(0, 1))}[dx]()
    if dx == 0:
        return {1: lambda: avg(G(0, 0), Hh(0, 0)), 2: lambda: Hh(0, 0),
                3: lambda: avg(Hh(0, 0), G(1, 0))}[dy]()
    if (dx, dy) == (2, 2):
        return J(0, 0)
    if dx == 2:
        return avg(B(0, 0), J(0, 0)) if dy == 1 else avg(J(0, 0), B(1, 0))
    if dy == 2:
        return avg(Hh(0, 0), J(0, 0)) if dx == 1 else avg(J(0, 0), Hh(0, 1))
    bb = B(0, 0) if dy == 1 else B(1, 0)
    hh = Hh(0, 0) if dx == 1 else Hh(0, 1)
    return avg(bb, hh)


def refine_plain(cur_y, ref_pad, bpl, hpl, jpl, int_mvx, int_mvy,
                 lambda_me: int):
    """Quarter-pel refinement (fast.py:194-228): the 49 ``_REFINE``
    offsets around each MB's integer vector, SSD plus rate, first minimum.
    Returns mvx, mvy (n_mb,) int32 quarter-pel and pred_y (H, W)."""
    H, W = cur_y.shape
    ys, xs = _mb_origins(H, W, cur_y.device)
    orig = _blocks(cur_y, 16).reshape(-1, 16, 16)
    bx, by = int_mvx.reshape(-1), int_mvy.reshape(-1)
    iy0, ix0 = ys + by + PAD, xs + bx + PAD
    preds, costs = [], []
    for ox, oy in _REFINE:
        pred = qpel_window((ref_pad, bpl, hpl, jpl), iy0 + (oy >> 2),
                           ix0 + (ox >> 2), ox & 3, oy & 3)
        d = orig - pred
        rate = mv_bits(bx * 4 + ox) + mv_bits(by * 4 + oy)
        costs.append(d.mul(d).sum((1, 2), dtype=I32)
                     + _lam_cost(int(lambda_me), rate))
        preds.append(pred)
    k = torch.stack(costs, 1).argmin(1)
    offs = torch.as_tensor(_REFINE, dtype=I32, device=cur_y.device)
    pred = torch.stack(preds, 1)[torch.arange(k.numel(), device=k.device), k]
    pred_y = _unblock(pred.reshape(H // 16, W // 16, 16, 16))
    return bx * 4 + offs[k, 0], by * 4 + offs[k, 1], pred_y


def luma_tq_plain(cur_y, pred_y, qp: int):
    """Luma residual coding (fast.py:231-240): 4x4 forward transform,
    inter quantization, dequantization, inverse and recon.  Returns lev
    (H/4, W/4, 4, 4) and rec_y (H, W) int32."""
    coefs = TR.forward4x4(_blocks(cur_y - pred_y, 4))
    lev = Q.quant4x4(coefs, qp, Q.default_offset4(qp, False))
    rres = TR.inverse4x4(Q.dequant4x4(lev, qp))
    rec = ((rres + (_blocks(pred_y, 4) << 6) + 32) >> 6).clamp(0, 255)
    return lev, _unblock(rec)


def chroma_plain(cur_c, ref_c_pad, mvx, mvy, qp_c: int):
    """One chroma plane (fast.py:246-293): the 8x8 1/8-pel bilinear
    prediction of each MB from its 9x9 window, then 4x4 forward transforms,
    the 2x2 DC Hadamard and its quantization, the AC quantization, the
    dequantization (the DC one truncating) and recon.  Returns lev_c
    (Hc/4, Wc/4, 4, 4), dc_lev (n_my, n_mx, 2, 2) and rec_c (Hc, Wc)."""
    Hc, Wc = cur_c.shape
    n_my, n_mx = Hc // 8, Wc // 8
    ys, xs = _mb_origins(2 * Hc, 2 * Wc, cur_c.device)
    A = _window(ref_c_pad, (ys >> 1) + (mvy >> 3) + PAD,
                (xs >> 1) + (mvx >> 3) + PAD, 9)
    fx, fy = (mvx & 7)[:, None, None], (mvy & 7)[:, None, None]
    blk = ((8 - fx) * (8 - fy) * A[:, :8, :8] + fx * (8 - fy) * A[:, :8, 1:]
           + (8 - fx) * fy * A[:, 1:, :8] + fx * fy * A[:, 1:, 1:] + 32) >> 6
    pred_c = _unblock(blk.reshape(n_my, n_mx, 8, 8))
    co = TR.forward4x4(_blocks(cur_c - pred_c, 4))
    dcm = co[:, :, 0, 0].reshape(n_my, 2, n_mx, 2).transpose(1, 2)
    dc_lev = Q.quant_chroma_dc(TR.hadamard2x2(dcm), qp_c, False)
    lev_c = Q.quant4x4(co, qp_c, Q.default_offset4(qp_c, False))
    lev_c[:, :, 0, 0] = 0
    deq = Q.dequant4x4(lev_c, qp_c)
    dc_deq = Q.dequant_chroma_dc(TR.hadamard2x2(dc_lev), qp_c)
    deq[:, :, 0, 0] = dc_deq.transpose(1, 2).reshape(Hc // 4, Wc // 4)
    rr = TR.inverse4x4(deq)
    rec = ((rr + (_blocks(pred_c, 4) << 6) + 32) >> 6).clamp(0, 255)
    return lev_c, dc_lev, _unblock(rec)


def refine_tq_plain(cur_y, cur_u, cur_v, ref_pad, bpl, hpl, jpl, ref_u_pad,
                    ref_v_pad, int_mvx, int_mvy, qp: int, qp_c: int,
                    lambda_me: int):
    """K13's plain version: the refinement, then luma and chroma coding.
    Returns (mvx, mvy, lev, rec_y, lev_u, dc_u, rec_u, lev_v, dc_v,
    rec_v)."""
    mvx, mvy, pred_y = refine_plain(cur_y, ref_pad, bpl, hpl, jpl, int_mvx,
                                    int_mvy, lambda_me)
    lev, rec_y = luma_tq_plain(cur_y, pred_y, qp)
    lev_u, dc_u, rec_u = chroma_plain(cur_u, ref_u_pad, mvx, mvy, qp_c)
    lev_v, dc_v, rec_v = chroma_plain(cur_v, ref_v_pad, mvx, mvy, qp_c)
    return mvx, mvy, lev, rec_y, lev_u, dc_u, rec_u, lev_v, dc_v, rec_v


def half_planes(Ypad):
    """The 6-tap half-pel planes b, h, j (H+59, W+59) of a padded luma
    plane (fast.py:491-516): K2's plain bank holds them shifted by 2
    samples with a 2/3-sample zero border."""
    bank = _bank_from_pad(Ypad.to(I32))
    return tuple(bank[k, 2:-3, 2:-3] for k in (1, 2, 3))


# ---------------------------------------------------------------------------
# the kernels a legacy P picture goes through
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LKernels:
    """The device entries of a legacy P picture: the CUDA kernel wrappers
    (``default_kernels``) or their plain versions (``PLAIN``)."""

    p16_search: object
    p16_refine: object
    strengths: object
    deblock: object
    ref_bank: object

    def names(self):
        return [f.name for f in fields(self)]


def default_kernels() -> LKernels:
    """The CUDA kernel wrappers (each runs its plain version on a CPU
    tensor)."""
    from ..kernels import deblock as K6
    from ..kernels import p16
    from ..kernels import ref_bank as K2

    return LKernels(p16.p16_search, p16.p16_refine, K6.strengths, K6.deblock,
                    K2.ref_bank)


PLAIN = LKernels(search_plain, refine_tq_plain, strengths_plain,
                 deblock_plain, ref_entry_plain)


def recording(k: LKernels):
    """(LKernels that run `k` and record every call as (name, args), the
    list they append to): the real inputs of each entry, for holding a
    kernel against its plain version."""
    calls: list = []

    def wrap(name, fn):
        def rec(*args):
            calls.append((name, args))
            return fn(*args)
        return rec

    return LKernels(**{n: wrap(n, getattr(k, n)) for n in k.names()}), calls


def ref_resources(Y, U, V, device=None, impl=None):
    """The reference state of recon planes (fast.py:304): (Ypad, b, h, j,
    Upad, Vpad) int32 on `device`, edge-padded by 32, as views of one K2
    bank entry (``impl``, K2's wrapper by default)."""
    from ..device import resolve_device
    from .rd import _to_i32

    if impl is None:
        impl = default_kernels().ref_bank
    dev = resolve_device(device)
    bank, cpad = impl(_to_i32(Y, dev), _to_i32(U, dev), _to_i32(V, dev))
    return (bank[0], *(bank[k, 2:-3, 2:-3] for k in (1, 2, 3)), cpad[0],
            cpad[1])


def strengths_device_p(lev, mvx, mvy, impl=None):
    """bS of an all-inter single-reference picture (fast.py:327): lev the
    4x4 levels (4 n_my, 4 n_mx, 4, 4) or coefficient flags (4 n_my,
    4 n_mx), int32; mvx/mvy int32 per MB, (n_my, n_mx) -> (BSV, BSH): 2
    with coefficients on either side, else 1 where a component differs by
    4 or more.  K6's ``strengths`` with one list, no intra MB and every
    block on reference 0 is that rule; it reads the per-MB mvs as they
    are."""
    if impl is None:
        impl = default_kernels().strengths
    n_my, n_mx = mvx.shape
    return impl(n_my, n_mx, lev, None, None, mvx.reshape(-1),
                mvy.reshape(-1))


def deblock_device_p(rec_y, rec_u, rec_v, BSV, BSH, qp: int, qp_c: int,
                     impl=None):
    """The raster-order bS <= 2 filter of the legacy picture (fast.py:396):
    K6's ``deblock`` (its anti-diagonal order equals raster order, and at
    bS <= 2 its filter is this one)."""
    if impl is None:
        impl = default_kernels().deblock
    return impl(rec_y, rec_u, rec_v, BSV, BSH, int(qp), int(qp_c))


def p_frame_core(cur_y, cur_u, cur_v, ref_pad, bpl, hpl, jpl, ref_u_pad,
                 ref_v_pad, H: int, W: int, R: int, qp: int, qp_c: int,
                 lambda_me: int, k: LKernels | None = None):
    """The pixel pipeline of one legacy P picture (fast.py:102) on int32
    planes: (mvx, mvy, lev, rec_y, lev_u, dc_u, rec_u, lev_v, dc_v, rec_v,
    grid0), the recon planes before the filter."""
    k = default_kernels() if k is None else k
    if tuple(cur_y.shape) != (H, W):
        raise ValueError(f"picture {tuple(cur_y.shape)} is not {H}x{W}")
    int_mvx, int_mvy, grid0 = k.p16_search(cur_y, ref_pad, int(R),
                                           int(lambda_me))
    out = k.p16_refine(cur_y, cur_u, cur_v, ref_pad, bpl, hpl, jpl,
                       ref_u_pad, ref_v_pad, int_mvx, int_mvy, int(qp),
                       int(qp_c), int(lambda_me))
    return (*out, grid0)


# the reference's pre-deblock single-call pipeline (fast.py:94) is the core
p_frame_device = p_frame_core


def p_frame_pipeline(cur_y8, cur_u8, cur_v8, ref_pad, bpl, hpl, jpl,
                     ref_u_pad, ref_v_pad, H: int, W: int, R: int, qp: int,
                     qp_c: int, lambda_me: int, k: LKernels | None = None):
    """One legacy P picture on the device of its planes (fast.py:43):
    uint8 (or int32) current planes and the previous reference state ->
    (host_out, (Y, U, V), next reference state).  host_out is one flat
    int32 buffer: mvx, mvy (n_mb) . lev (H/4, W/4, 4, 4) . lev_u, dc_u,
    lev_v, dc_v; the recon planes are the filtered ones; the next
    reference is (Ypad, b, h, j, Upad, Vpad) of them, on the device."""
    k = default_kernels() if k is None else k
    cur = tuple(p.to(I32).contiguous() for p in (cur_y8, cur_u8, cur_v8))
    (mvx, mvy, lev, rec_y, lev_u, dc_u, rec_u, lev_v, dc_v, rec_v,
     _) = p_frame_core(*cur, ref_pad, bpl, hpl, jpl, ref_u_pad, ref_v_pad,
                       H, W, R, qp, qp_c, lambda_me, k)
    n_my, n_mx = H // 16, W // 16
    BSV, BSH = strengths_device_p(lev, mvx.reshape(n_my, n_mx),
                                  mvy.reshape(n_my, n_mx), impl=k.strengths)
    recon = deblock_device_p(rec_y, rec_u, rec_v, BSV, BSH, qp, qp_c,
                             impl=k.deblock)
    new_ref = ref_resources(*recon, device=rec_y.device, impl=k.ref_bank)
    host_out = torch.cat([mvx.reshape(-1), mvy.reshape(-1), lev.reshape(-1),
                          lev_u.reshape(-1), dc_u.reshape(-1),
                          lev_v.reshape(-1), dc_v.reshape(-1)])
    return host_out, recon, new_ref
