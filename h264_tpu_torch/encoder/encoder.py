"""H.264 encoder on a CUDA card: IPB, IPPP and all-intra streams, CABAC or
CAVLC, with or without the FRExt 8x8 transform.

The PyTorch counterpart of the reference package's encoder/encoder.py.
An IDR picture is coded by the device intra pipeline
(``rd.rd_i_pipeline``: full-RD I16 vs I4x4 on the card), deblocked by the
native host filter and entropy-coded (CABAC or CAVLC); it then
gets its reference bank entry on the card (``rd.ref_entry_from_planes``).
A P picture runs whole on the card (``rd_p.rd_p_pipeline``: motion search,
partition and mode decisions, residual coding, intra commit, deblocking
and its own next reference entry, and with ``transform8x8`` the 8x8
transform decision of the High profile), up to ``pipeline_depth``
pictures ahead of the host, which fetches each group's flat outputs in one
copy, fills the parse state and entropy-codes the slices (the native CABAC
or CAVLC writer; B slices and 8x8-transform slices of a CAVLC stream go
through the Python CAVLC writer, as in the reference).  Explicit weighted
prediction is estimated on the host (float64 numpy, as the reference).
With ``b_frames`` B pictures between anchors the stream goes out in
decode order (each anchor before the B pictures that reference it, and
with ``b_hierarchy`` the stored middle B before the outer ones); a B
picture also runs whole on the card (``rd_b.rd_b_pipeline``: two-list
search and refinement, temporal direct, bi-prediction, the same residual,
commit and filter stages), and its host tail adds the temporal direct
fill from the anchor's parse state.

Every other configuration raises NotImplementedError naming its ROADMAP
item: custom scaling matrices, intra refresh, loss-aware RDO, tile-row
slices, rate control, multi-slice / FMO, SEI and the host-path encoder
(``fast=False``, ``rd=False``, ``enable_i4=False``).
No half-ported path runs.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream import NalUnit, write_annexb
from ..config import level_for, profile_check
from ..decoder import mbtables as M
from ..decoder.mv import dist_scale_factor
from ..decoder.recon import Planes
from ..decoder.state import PictureParseState
from ..device import resolve_device
from ..kernels.intra_commit import intra_commit_step
from ..kernels.ref_bank import ref_bank
from ..ops.deblock import deblock_picture
from ..ops.exact import chroma_qp
from ..syntax.parsets import PPS, SPS, write_pps, write_sps
from ..syntax.slice_header import (PredWeight, SliceHeader, SliceType,
                                   write_slice_header)
from . import fills as FL
from . import rd as RD
from . import rd_b as RDB
from . import rd_p as RDP
from .syntax_cabac import CabacSliceWriter
from .syntax_cavlc import CavlcSliceWriter


@dataclass
class EncoderConfig:
    width: int
    height: int
    qp: int = 28
    search_range: int = 16
    idr_period: int = 0  # 0: only first frame is IDR
    enable_i4: bool = True
    enable_deblock: bool = True
    subpel: bool = True
    num_ref_frames: int = 1
    fast: bool = False  # device-batched P-frame pipeline
    rd: bool = True  # RD mode decision in the fast path (partitions,
    # multi-ref, skip-RD, intra-in-P); False = legacy P16x16-only path
    row_slices: int = 1  # tile-row slice groups in the rd fast path: each
    # group is an independent slice (deblock idc=2) — the unit of
    # tile-row sharding across chips (rd.rd_p_rows_pipeline)
    entropy: str = "cavlc"  # "cavlc" (Baseline) or "cabac" (Main)
    pipeline_depth: int = 8  # frames in flight in encode_stream
    b_frames: int = 0  # B pictures between anchors (0 = IPPP)
    qp_b_offset: int = 2  # QP delta for (non-reference) B pictures
    b_hierarchy: bool = False  # 2-layer B pyramid (b_frames == 3): the
    # middle B is a stored reference (explicit_gop.c:32 create_hierarchy)
    rc_bitrate: float = 0.0  # target bits/s; 0 disables rate control
    rc_fps: float = 30.0  # frame rate assumed by rate control
    # multi-slice / FMO (lencod SliceMode/SliceArgument + slice groups)
    slice_mode: int = 0  # 0: one slice per group; 1: fixed MBs per slice
    slice_argument: int = 0  # MBs per slice for slice_mode 1
    num_slice_groups: int = 1
    slice_group_map_type: int = 0
    slice_group_run_length: tuple = ()  # type 0 run lengths (MBs)
    slice_group_rects: tuple = ()  # type 2 (top_left, bottom_right) pairs
    slice_group_ids: tuple = ()  # type 6 explicit map
    slice_group_change_direction: bool = False  # types 3-5
    slice_group_change_rate: int = 1  # types 3-5 (map units)
    slice_group_change_cycle: int = 1  # types 3-5
    # SEI (lencod GenerateSEIMessage/SEIMessageText,
    # ToneMappingSEIPresentFlag/ToneMappingFile, + recovery point)
    sei_text: str = ""  # user_data_unregistered payload text
    sei_tone_mapping: object = None  # syntax.sei.ToneMapping or None
    sei_recovery_point: bool = False  # recovery point SEI at each IDR
    # FRExt / High profile (lencod Transform8x8Mode,
    # ScalingMatrixPresentFlag + q_matrix.cfg)
    transform8x8: bool = False  # allow 8x8 transform (host path)
    weighted_pred: bool = False  # P-slice explicit WP (DC-ratio luma
    # estimation, lencod/src/weighted_prediction.c:30); fast RD path
    redundant_pics: bool = False  # emit a redundant coded slice after
    # each primary P slice (host path; lencod.c:2718 redundant frames)
    loss_aware_k: int = 0  # loss-aware RDO: simulated lossy decoders
    # (lencod rdopt=3 NumberOfDecoders; 0 disables)
    loss_rate: float = 0.1  # per-frame slice loss probability (LossRateA)
    intra_refresh: int = 0  # forced-intra MBs per P frame (lencod
    # RandomIntraMBRefresh, intrarefresh.c:97): pseudo-random without
    # repetition until the whole frame has been refreshed
    partition_mode: int = 0  # 1: CAVLC data partitioning (DPA/DPB/DPC
    # NALs; spec §7.3.2.8-.10, lencod/src/header.c:541) on non-IDR pics
    scaling_lists: object = None  # (ws4 (6,4,4), ws8 (2,8,8)) raster or None


# configuration -> the ROADMAP Queue 1 item that brings it
_NOT_PORTED = (
    (lambda c: not c.fast, "fast=False (host-path encoder)", "Host-path ME"),
    (lambda c: not c.rd, "rd=False (legacy P16x16 path)", "Legacy P16x16 path"),
    (lambda c: not c.enable_i4, "enable_i4=False (host-path intra)",
     "Host-path ME"),
    (lambda c: c.scaling_lists is not None,
     "custom scaling matrices (the reference's host path)", "Host-path ME"),
    (lambda c: c.intra_refresh > 0, "intra refresh", "Intra refresh"),
    (lambda c: c.loss_aware_k > 0, "loss-aware RDO", "Loss-aware RDO"),
    (lambda c: c.row_slices > 1, "tile-row slices", "Tile-row slices"),
    (lambda c: c.rc_bitrate > 0, "rate control", "Rate control"),
    (lambda c: c.slice_mode != 0 or c.num_slice_groups > 1,
     "multi-slice / FMO", "Host-path ME"),
    (lambda c: bool(c.sei_text) or c.sei_tone_mapping is not None
     or c.sei_recovery_point, "SEI messages", "Config and CLIs"),
    (lambda c: c.redundant_pics or c.partition_mode == 1,
     "redundant pictures / data partitioning", "Host-path ME"),
)


class H264Encoder:
    """IPB / IPPP / all-intra encoder (CABAC or CAVLC, 4x4 or 4x4/8x8
    transforms); ``device`` is where the
    picture decisions, the P and B pipelines and the reference banks run
    (CUDA unless told otherwise)."""

    # the kernel wrappers the pictures go through (a subclass may name
    # their plain versions to run the plain path on the card): the I
    # picture's commit step and reference entry, and every entry of the
    # P and B pipelines (rd_p.PKernels, rd_b.BKernels; None means their
    # default_kernels())
    _intra_step = staticmethod(intra_commit_step)
    _ref_bank = staticmethod(ref_bank)
    _p_kernels = None
    _b_kernels = None

    def __init__(self, cfg: EncoderConfig, device=None):
        if cfg.width % 16 or cfg.height % 16:
            raise ValueError(
                f"picture size {cfg.width}x{cfg.height} is not a multiple "
                "of 16")
        for test, what, item in _NOT_PORTED:
            if test(cfg):
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP Queue 1: {item})")
        if cfg.b_hierarchy and cfg.b_frames != 3:
            raise ValueError("2-layer pyramid needs b_frames == 3")
        if cfg.b_frames > 0 and not 0 <= cfg.qp + cfg.qp_b_offset <= 51:
            raise ValueError(f"B picture QP {cfg.qp} + {cfg.qp_b_offset} "
                             "outside 0..51")
        profile_check(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        use_b = cfg.b_frames > 0
        self.sps = SPS(
            # Baseline unless CABAC or B pictures (Main); High below
            profile_idc=77 if (cfg.entropy == "cabac" or use_b) else 66,
            level_idc=max(30, level_for(
                cfg.width, cfg.height, cfg.rc_fps,
                cfg.num_ref_frames + (1 if use_b else 0))),
            # with B pictures the DPB also keeps the future anchor (and
            # the stored middle B of a pyramid), so the colocated
            # references of temporal direct stay in the B slice's list 0
            num_ref_frames=cfg.num_ref_frames + (
                (2 if cfg.b_hierarchy else 1) if use_b else 0),
            pic_width_in_mbs_minus1=cfg.width // 16 - 1,
            pic_height_in_map_units_minus1=cfg.height // 16 - 1,
            # decode order differs from display order: explicit POC
            pic_order_cnt_type=0 if use_b else 2,
            log2_max_pic_order_cnt_lsb_minus4=4,
            log2_max_frame_num_minus4=4,
        )
        self.pps = PPS(entropy_coding_mode_flag=(cfg.entropy == "cabac"))
        if cfg.transform8x8:
            # High profile (FREXT_HP): the 8x8 transform is signalled there
            # (lencod/src/parset.c GenerateSPS)
            self.sps.profile_idc = 100
            self.pps.transform_8x8_mode_flag = True
            self.pps.second_chroma_qp_index_offset = 0
        if cfg.search_range > 28:
            warnings.warn(
                f"device pipelines clamp SearchRange {cfg.search_range} "
                "-> 28 (dense-grid memory shape); the coarse-to-fine "
                "pre-search still reaches +-48 full-pel beyond it",
                stacklevel=2)
        if cfg.weighted_pred:
            self.pps.weighted_pred_flag = True
        self._src_dc: dict = {}  # poc -> source-luma mean (WP estimation)
        self._src_sd: dict = {}  # poc -> source-luma std (WP gain)
        self._src_ds: dict = {}  # poc -> 8x-decimated source luma (WP test)
        self.frame_num = 0
        self.idr_count = 0
        self._prev_poc = 0
        self.all_recons: list = []  # (poc, planes) of every picture
        self.recon_pics: list = []  # (poc, planes, parse state, None) refs
        self._rd_refs: list = []  # [(poc, bank, cpad, col)] newest-first
        self._anchor_ref_pocs: dict = {}  # ref poc -> its col index space
        # set to a list to have every finished picture appended as (type
        # "I"/"P"/"B", poc, its fetched host_out or None for I)
        self.picture_log: list | None = None
        # JM lambda (lencod/src/slice.c:1261, rdopt on): base 0.68 when B
        # pictures are in use, else 0.85, x0.95 for the non-SATD ME
        # metric, in <<16 fixed point (B slices scale it in _start_b_rd)
        lam = self._lambda_base() * 2.0 ** ((cfg.qp - 12) / 3.0)
        self.lambda_mode_fx = int(lam * 65536 + 0.5)

    def _lambda_base(self) -> float:
        return (0.68 if self.cfg.b_frames > 0 else 0.85) * 0.95

    def _log_picture(self, kind: str, poc: int, fetched) -> None:
        if self.picture_log is not None:
            self.picture_log.append((kind, poc, fetched))

    def _poc_lsb(self, poc: int) -> int:
        """pic_order_cnt_lsb of a slice header (0 without explicit POC)."""
        sps = self.sps
        if sps.pic_order_cnt_type != 0:
            return 0
        return poc % (1 << (sps.log2_max_pic_order_cnt_lsb_minus4 + 4))

    # ------------------------------------------------------------------
    def headers(self) -> list[NalUnit]:
        return [
            NalUnit(7, 3, write_sps(self.sps)),
            NalUnit(8, 3, write_pps(self.pps)),
        ]

    def encode_sequence(self, frames) -> bytes:
        """frames: list of (Y, U, V) uint8 arrays. Returns Annex-B bytes."""
        nalus = self.headers()
        for out in self.encode_stream(frames):
            nalus.extend(out)
        return write_annexb(nalus)

    def encode_stream(self, frames, depth: int | None = None):
        """Pipelined encode: yields a list of NalUnits per frame.  P
        pictures are dispatched to the card up to `depth` frames ahead of
        the host tail (the reference chain stays on the card); each group
        is fetched in one copy and then entropy-coded in order.  With B
        pictures the pictures come out in decode order, the groups hold
        at least 2 pictures unless `depth` is given (1 fetches and codes
        every picture as soon as it is dispatched: the same stream)."""
        if self.cfg.b_frames > 0:
            yield from self._encode_stream_b_rd(frames, depth)
            return
        if depth is None:
            depth = self.cfg.pipeline_depth
        pend: list = []
        for idx, yuv in enumerate(frames):
            is_idr = idx == 0 or (
                self.cfg.idr_period and idx % self.cfg.idr_period == 0
            )
            if is_idr:
                yield from self._drain(pend)
                pend = []
                yield self.encode_frame(yuv, True)
            else:
                pend.append(self._start_p_rd(yuv))
                if len(pend) >= depth:
                    yield from self._drain(pend)
                    pend = []
        yield from self._drain(pend)

    def _drain(self, group):
        if group:
            rows = fetch_group([p[0] for p in group])
            for row, p in zip(rows, group):
                yield self._finish_p_rd(p, row)

    # ------------------------------------------------------------------
    def encode_frame(self, yuv, is_idr: bool) -> list[NalUnit]:
        if not is_idr and self.cfg.b_frames > 0:
            # the reference codes this P picture on its host path
            raise NotImplementedError(
                "a lone P picture of a B configuration is not ported yet "
                "(ROADMAP Queue 1: Host-path ME)")
        if not is_idr:
            p = self._start_p_rd(yuv)
            return self._finish_p_rd(p, fetch_group([p[0]])[0])
        return self._encode_picture(yuv, SliceType.I, True, 0)

    def _encode_picture(self, yuv, stype: SliceType, is_idr: bool,
                        poc: int) -> list[NalUnit]:
        cfg = self.cfg
        Y = np.asarray(yuv[0], np.int32)
        U = np.asarray(yuv[1], np.int32)
        V = np.asarray(yuv[2], np.int32)
        self._src_dc[poc] = float(Y.mean())
        self._src_sd[poc] = float(Y.std())
        self._src_ds[poc] = np.asarray(Y, np.float64)[::8, ::8]
        sps, pps = self.sps, self.pps
        W, H = sps.pic_width_in_mbs, sps.frame_height_in_mbs
        st = PictureParseState(W, H)
        planes = Planes(sps)
        if is_idr:
            self._rd_refs.clear()
            self.recon_pics.clear()
            self.frame_num = 0
        qp = cfg.qp
        addrs = list(range(st.n_mbs))  # one slice
        st.slice_id[:] = 0
        st.qp[:] = qp
        cb_off, cr_off = pps.chroma_qp_offset
        st.qpc[:, 0] = chroma_qp(qp, cb_off)
        st.qpc[:, 1] = chroma_qp(qp, cr_off)
        self._device_intra_picture(st, planes, Y, U, V, qp)
        if cfg.enable_deblock:
            deblock_picture(st, sps, planes)

        sh = SliceHeader(
            first_mb_in_slice=0,
            slice_type_code=stype.value,
            frame_num=self.frame_num % sps.max_frame_num,
            is_idr=is_idr,
            nal_ref_idc=3,
            idr_pic_id=self.idr_count % 2 if is_idr else 0,
            pic_order_cnt_lsb=self._poc_lsb(poc),
            direct_spatial_mv_pred_flag=False,
            slice_qp_delta=qp - (26 + pps.pic_init_qp_minus26),
            slice_group_change_cycle=cfg.slice_group_change_cycle,
        )
        w = write_slice_header(sh, sps, pps)
        self._write_slice_data(w, st, sh, addrs)
        nals = [NalUnit(5 if is_idr else 1, 3, w.get_bytes())]

        self.all_recons.append((poc, planes))
        self._log_picture(stype.name, poc, None)
        bank, cpad = RD.ref_entry_from_planes(
            planes.Y, planes.U, planes.V, device=self.device,
            impl=self._ref_bank)
        # intra pictures entering the device DPB: colocated motion is
        # all-intra
        H4, W4 = 4 * H, 4 * W
        z = torch.zeros((H4, W4), dtype=torch.int32, device=self.device)
        col = (torch.ones((H4, W4), dtype=torch.bool, device=self.device),
               z, z.clone(), z.clone())
        self._rd_refs = ([(poc, bank, cpad, col)] + self._rd_refs)[
            : sps.num_ref_frames]
        self._anchor_ref_pocs[poc] = []
        self.recon_pics = [(poc, planes, st, None)] if is_idr else (
            self.recon_pics + [(poc, planes, st, None)])[-sps.num_ref_frames:]
        self._prev_poc = poc
        self.frame_num += 1
        if is_idr:
            self.idr_count += 1
        return nals

    # ------------------------------------------------------------------
    def _start_p_rd(self, yuv, poc: int | None = None):
        """Dispatch the device RD pipeline for a P picture (partitions,
        multi-ref, skip-RD, intra-in-P; rd_p.rd_p_pipeline); `poc` is
        given in display order with B pictures, else the next one.
        Returns the pending state ``_finish_p_rd`` completes; nothing here
        waits for the card."""
        cfg, sps, pps = self.cfg, self.sps, self.pps
        H, W = sps.height, sps.width
        qp = cfg.qp
        lam_fx = self.lambda_mode_fx
        cb_off, _ = pps.chroma_qp_offset
        qp_c = chroma_qp(qp, cb_off)
        dev = self.device
        cur = tuple(RD._to_i32(np.ascontiguousarray(p, np.uint8), dev)
                    for p in yuv)
        refs = self._rd_refs[: max(1, cfg.num_ref_frames)]
        # pad the bank stack to a fixed depth (masked via nref), as the
        # reference does to reuse one executable while the DPB warms up
        nr_max = max(1, cfg.num_ref_frames)
        pad = [refs[-1]] * (nr_max - len(refs))
        banks = torch.stack([e[1] for e in refs + pad])
        cpads = torch.stack([e[2] for e in refs + pad])
        ref_pocs = [e[0] for e in refs]
        wp_weights = None
        wp_w = wp_o = None
        if cfg.weighted_pred:
            # luma (weight, offset) per reference, logWD = 5.  Three
            # candidates per ref — DC-ratio gain (the JM default,
            # weighted_prediction.c:30), identity+DC offset (JM
            # select_offset), and std-ratio gain + offset — scored by
            # actual prediction SAD on 8x-decimated source planes (the
            # measurement replaces JM's multi-pass WP RD test,
            # weighted_prediction.c:373 test_wp_P_slice).  Host float64
            # numpy, exactly as the reference package computes it.
            ysrc = np.asarray(yuv[0], np.float64)
            cur_ds = ysrc[::8, ::8]
            dc_cur = float(ysrc.mean())
            sd_cur = float(ysrc.std())
            wp_weights = []
            for rp in ref_pocs:
                dc_ref = self._src_dc.get(rp, 0.0)
                sd_ref = self._src_sd.get(rp, 0.0)
                ref_ds = self._src_ds.get(rp)
                cands = [(32, 0)]
                if dc_ref > 0:
                    cands.append(
                        (max(-128, min(127, int(32 * dc_cur / dc_ref + 0.5))),
                         0))
                cands.append((32, max(-128, min(127,
                                                int(dc_cur - dc_ref + 0.5)))))
                if sd_ref > 1e-3:
                    w = max(-128, min(127, int(32 * sd_cur / sd_ref + 0.5)))
                    o = max(-128, min(127,
                                      int(dc_cur - w * dc_ref / 32.0 + 0.5)))
                    cands.append((w, o))
                if ref_ds is not None and ref_ds.shape == cur_ds.shape:
                    sads = [np.abs(cur_ds - (np.floor(
                        (ref_ds * w + 16) / 32) + o)).mean()
                        for (w, o) in cands]
                    wp_weights.append(cands[int(np.argmin(sads))])
                else:
                    wp_weights.append(cands[1] if len(cands) > 1 else (32, 0))
            wpad = wp_weights + [wp_weights[-1]] * (nr_max - len(wp_weights))
            wp_w = np.asarray([p[0] for p in wpad], np.int32)
            wp_o = np.asarray([p[1] for p in wpad], np.int32)
        host_out, recon, new_entry = RDP.rd_p_pipeline(
            *cur, banks, cpads, H=H, W=W, R=min(cfg.search_range, 28),
            qp=qp, qp_c=qp_c, lam=lam_fx, lam_me=2 * lam_fx,
            nref=len(refs), wp_w=wp_w, wp_o=wp_o, device=dev,
            k=self._p_kernels, use_t8=bool(cfg.transform8x8))
        frame_num = self.frame_num
        self.frame_num += 1
        if poc is None:
            poc = self._prev_poc + 2
        self._prev_poc = poc
        self._anchor_ref_pocs[poc] = ref_pocs
        self._rd_refs = ([(poc,) + tuple(new_entry)] + self._rd_refs)[
            : sps.num_ref_frames]
        self._src_dc[poc] = float(np.asarray(yuv[0], np.float64).mean())
        self._src_sd[poc] = float(np.asarray(yuv[0], np.float64).std())
        self._src_ds[poc] = np.asarray(yuv[0], np.float64)[::8, ::8]
        return (host_out, recon, frame_num, poc, ref_pocs, qp, wp_weights)

    def _finish_p_rd(self, pending, fetched) -> list[NalUnit]:
        """Host tail of a dispatched P picture: split its fetched flat
        outputs (`fetched`, numpy), fill the parse state and entropy-code
        the slice."""
        (_, recon, frame_num, poc, ref_pocs, qp, wp_weights) = pending
        sps, pps = self.sps, self.pps
        W, H = sps.pic_width_in_mbs, sps.frame_height_in_mbs
        n_mb = W * H
        st = PictureParseState(W, H)
        planes = Planes(sps)
        st.slice_id[:] = 0
        cb_off, cr_off = pps.chroma_qp_offset
        st.qp[:] = qp
        st.qpc[:, 0] = chroma_qp(qp, cb_off)
        st.qpc[:, 1] = chroma_qp(qp, cr_off)
        sizes = [n_mb, 4 * n_mb, 4 * n_mb, n_mb, 16 * n_mb, 16 * n_mb,
                 n_mb, n_mb, 256 * n_mb, 256 * n_mb, 16 * n_mb,
                 128 * n_mb, 8 * n_mb, 16 * n_mb]
        parts = np.split(fetched[: sum(sizes)], np.cumsum(sizes)[:-1])
        win = parts[0]
        ref8 = parts[1].reshape(n_mb, 4)
        b8sub = parts[2].reshape(n_mb, 4)
        t8 = parts[3]
        mv4x = parts[4].reshape(n_mb, 4, 4)
        mv4y = parts[5].reshape(n_mb, 4, 4)
        i16mode = parts[6]
        cip = parts[7]
        lev = parts[8].reshape(n_mb, 4, 4, 4, 4)
        lev8 = parts[9].reshape(n_mb, 2, 2, 8, 8)
        dc = parts[10].reshape(n_mb, 4, 4)
        levc = parts[11].reshape(n_mb, 2, 2, 2, 4, 4)
        dcc = parts[12].reshape(n_mb, 2, 2, 2)
        ipm_plane = parts[13].reshape(4 * H, 4 * W)
        planes.Y, planes.U, planes.V = (x.cpu().numpy() for x in recon)
        self._fill_p_state_rd(st, win, ref8, b8sub, mv4x, mv4y, i16mode,
                              cip, lev, dc, levc, dcc, ref_pocs, ipm_plane,
                              t8, lev8)
        nr = len(ref_pocs)
        sh = SliceHeader(
            first_mb_in_slice=0,
            slice_type_code=SliceType.P.value,
            frame_num=frame_num % sps.max_frame_num,
            is_idr=False,
            nal_ref_idc=3,
            pic_order_cnt_lsb=self._poc_lsb(poc),
            num_ref_idx_active_override_flag=nr - 1
            != pps.num_ref_idx_l0_default_active_minus1,
            num_ref_idx_l0_active_minus1=nr - 1,
            disable_deblocking_filter_idc=0,
            slice_qp_delta=qp - (26 + pps.pic_init_qp_minus26),
        )
        if wp_weights is not None:
            # chroma is never weighted: weight 32, offset 0 (logWD 5)
            sh.luma_log2_weight_denom = 5
            sh.chroma_log2_weight_denom = 5
            sh.pred_weights[0] = [PredWeight(wv, ov, [32, 32], [0, 0])
                                  for (wv, ov) in wp_weights]
        w = write_slice_header(sh, sps, pps)
        self._write_slice_data(w, st, sh, list(range(n_mb)))
        self.all_recons.append((poc, planes))
        self._log_picture("P", poc, fetched)
        self.recon_pics = (self.recon_pics + [(poc, planes, st, None)])[
            -sps.num_ref_frames:]
        return [NalUnit(1, 3, w.get_bytes())]

    def _write_slice_data(self, w, st, sh, addrs) -> None:
        """Entropy-code one slice's data after its header: CABAC slices
        end byte-aligned after the flush (no stop bit), CAVLC slices with
        the RBSP trailing bits."""
        if self.pps.entropy_coding_mode_flag:
            CabacSliceWriter(st, self.sps, self.pps, sh).write_slice_data(
                w, addrs)
        else:
            CavlcSliceWriter(st, self.sps, self.pps, sh).write_slice_data(
                w, addrs)
            w.rbsp_trailing_bits()

    def _fill_p_state_rd(self, st, win, ref8, b8sub, mv4x, mv4y, i16mode,
                         cip, lev, dc, levc, dcc, ref_pocs, ipm_plane,
                         t8, lev8):
        """Decode-state fill for the RD pipeline interchange buffer.

        mv4x/mv4y: (n_mb, 4 units, 4 subpos) per-4x4 motion; b8sub:
        (n_mb, 4) device sub-mode code per unit (0 8x8 / 1 8x4 / 2 4x8
        / 3 4x4), meaningful for P8x8 winners; t8 (n_mb,) the
        transform_size_8x8 flags and lev8 (n_mb, 2, 2, 8, 8) their 8x8
        levels (zero without the T8 stage)."""
        n_mb = st.n_mbs
        n_my, n_mx = st.H, st.W
        i4 = win == RDP.C_I4
        i16 = win == RDP.C_I16
        intra = i16 | i4
        st.ipredmode[:] = ipm_plane.reshape(4 * n_my, 4 * n_mx)
        st.is_intra[:] = intra
        st.i16mode[:] = np.where(i16, i16mode, -1)
        st.c_ipred_mode[:] = np.where(intra, cip, 0)
        # mb types / partition modes
        type_map = {RDP.C_P16x16: M.P16x16, RDP.C_P16x8: M.P16x8,
                    RDP.C_P8x16: M.P8x16, RDP.C_P8x8: M.P8x8,
                    RDP.C_SKIP: M.P16x16, RDP.C_P16PMV: M.P16x16,
                    RDP.C_I16: M.I16MB, RDP.C_I4: M.I4MB}
        b8_map = {RDP.C_P16x16: 1, RDP.C_P16x8: 2, RDP.C_P8x16: 3,
                  RDP.C_P8x8: M.B8_8x8, RDP.C_SKIP: 1, RDP.C_P16PMV: 1,
                  RDP.C_I16: 0, RDP.C_I4: M.IBLOCK}
        st.mb_type[:] = np.vectorize(type_map.get)(win)
        st.b8mode[:] = np.vectorize(b8_map.get)(win)[:, None]
        # P8x8 winners carry the device sub-mode per unit
        _SUBMAP = np.asarray(
            [M.B8_8x8, M.B8_8x4, M.B8_4x8, M.B8_4x4], np.int32)
        p88 = win == RDP.C_P8x8
        st.b8mode[p88] = _SUBMAP[b8sub[p88]]
        st.b8pdir[:] = np.where(intra, -1, 0)[:, None]

        # per-4x4 picture-plane fields from the (unit, subpos) layout
        def to_pic4(a):  # (n_mb, 4, 4) -> (4*n_my, 4*n_mx)
            return (a.reshape(n_my, n_mx, 2, 2, 2, 2)
                    .transpose(0, 2, 4, 1, 3, 5)
                    .reshape(4 * n_my, 4 * n_mx))

        def to_pic4_u(a8):  # (n_mb, 4) per-unit -> (4*n_my, 4*n_mx)
            p = (a8.reshape(n_my, n_mx, 2, 2).transpose(0, 2, 1, 3)
                 .reshape(2 * n_my, 2 * n_mx))
            return np.repeat(np.repeat(p, 2, 0), 2, 1)

        mv4x, mv4y, ref4 = to_pic4(mv4x), to_pic4(mv4y), to_pic4_u(ref8)
        intra4 = np.repeat(np.repeat(intra.reshape(n_my, n_mx), 4, 0), 4, 1)
        st.mv[0, ..., 0] = np.where(intra4, 0, mv4x)
        st.mv[0, ..., 1] = np.where(intra4, 0, mv4y)
        st.ref_idx[0] = np.where(intra4, -1, ref4)
        poc_of = np.asarray(ref_pocs, np.int64)
        st.ref_pic_id[0] = np.where(
            intra4, -(10 ** 9), poc_of[np.clip(ref4, 0, len(ref_pocs) - 1)]
        )
        # residual levels (device (br, bc) -> coded Z-order blocks)
        zperm = np.empty(16, np.int64)
        for br in range(4):
            for bc in range(4):
                zperm[int(M.XY_TO_BLK4[br, bc])] = br * 4 + bc
        st.luma_levels[:] = lev.reshape(n_mb, 16, 4, 4)[:, zperm]
        st.luma_dc[:] = np.where(i16[:, None, None], dc, 0)
        st.chroma_levels[:] = levc.reshape(n_mb, 2, 4, 4, 4)
        st.chroma_dc[:] = dcc
        t8b = t8.astype(bool)
        # transform_size_8x8 winners: flag + 8x8 levels
        st.transform8x8[t8b] = 1
        st.luma8_levels[t8b] = lev8.reshape(n_mb, 4, 8, 8)[t8b]
        # cbp: I16 -> all-or-nothing luma; I4/inter -> per-8x8 bits
        nz4 = lev.any(axis=(3, 4))  # (n_mb, br, bc)
        # a nonzero 8x8 block marks its four 4x4 cells
        nz8 = lev8.any(axis=(3, 4)).reshape(n_mb, 2, 2)
        nz4 = nz4 | (np.repeat(np.repeat(nz8, 2, 1), 2, 2)
                     & t8b[:, None, None])
        q8 = nz4.reshape(n_mb, 2, 2, 2, 2).any(axis=(2, 4))
        cbp_inter = (q8[:, 0, 0] * 1 + q8[:, 0, 1] * 2 + q8[:, 1, 0] * 4
                     + q8[:, 1, 1] * 8)
        cbp_l = np.where(i16, np.where(nz4.any((1, 2)), 15, 0), cbp_inter)
        has_ac = levc.any(axis=(2, 3, 4, 5)).any(axis=1)
        has_dc = dcc.any(axis=(2, 3)).any(axis=1)
        cbp_c = np.where(has_ac, 2, np.where(has_dc, 1, 0))
        st.cbp[:] = cbp_l + 16 * cbp_c
        # transform_size_8x8_flag is only transmitted when luma cbp != 0
        # (need_transform_size); an untransmitted flag must read 0 for
        # the decoder's CABAC neighbour contexts (macroblock.c:2901)
        st.transform8x8[(st.cbp & 15) == 0] = 0
        weights = (1 << np.arange(16, dtype=np.int64)).reshape(4, 4)
        cbp_blk = (nz4 * weights).sum(axis=(1, 2))
        dc_any = dc.any(axis=(1, 2)) & i16
        st.cbp_blk = (cbp_blk | dc_any).tolist()
        # exact PMV/MVD + skip detection (whole-frame vectorized; legal
        # because every neighbor MV above is final device output)
        FL.fill_p_mvd_skip(st, win, RDP)

    # ------------------------------------------------------------------
    # B pictures (temporal direct)
    # ------------------------------------------------------------------
    def _encode_stream_b_rd(self, frames, depth: int | None = None):
        """Decode-order emission I (B^n P)* (lencod NumberBFrames): each
        anchor P is dispatched before the B pictures that reference it;
        POC is twice the display index since the last IDR.  Pictures go
        to the card up to `depth` (default max(2, pipeline_depth)) ahead
        of the host, and each group comes back in one copy."""
        nb = self.cfg.b_frames
        idr_p = self.cfg.idr_period
        depth = (max(2, self.cfg.pipeline_depth) if depth is None
                 else max(1, depth))
        pend_src: list = []  # display frames awaiting their anchor
        pend_dev: list = []  # dispatched pictures, decode order
        base = 0

        def drain():
            if pend_dev:
                rows = fetch_group([p[0] for _, p in pend_dev])
                for (tag, p), row in zip(pend_dev, rows):
                    yield (self._finish_p_rd(p, row) if tag == "p"
                           else self._finish_b_rd(p, row))
                pend_dev.clear()

        def dispatch(tag, pending):
            pend_dev.append((tag, pending))
            return drain() if len(pend_dev) >= depth else iter(())

        for idx, yuv in enumerate(frames):
            is_idr = idx == 0 or (idr_p and idx % idr_p == 0)
            if is_idr:
                for b_yuv, b_idx in pend_src:  # close the GOP with P
                    yield from dispatch("p", self._start_p_rd(
                        b_yuv, poc=2 * (b_idx - base)))
                pend_src = []
                base = idx
                yield from drain()
                yield self._encode_picture(yuv, SliceType.I, True, 0)
            elif len(pend_src) < nb:
                pend_src.append((yuv, idx))
            else:
                yield from dispatch("p", self._start_p_rd(
                    yuv, poc=2 * (idx - base)))
                if self.cfg.b_hierarchy:
                    # 2-layer pyramid A0 b1 B2 b3 A1: the stored middle B,
                    # then the outer ones (explicit_gop.c:32
                    # create_hierarchy)
                    (y1, i1), (y2, i2), (y3, i3) = pend_src
                    order = [(y2, i2, True), (y1, i1, False),
                             (y3, i3, False)]
                else:
                    order = [(y, i, False) for y, i in pend_src]
                for b_yuv, b_idx, is_ref in order:
                    yield from dispatch("b", self._start_b_rd(
                        b_yuv, 2 * (b_idx - base), is_ref=is_ref))
                pend_src = []
        for b_yuv, b_idx in pend_src:
            yield from dispatch("p", self._start_p_rd(
                b_yuv, poc=2 * (b_idx - base)))
        yield from drain()

    def _start_b_rd(self, yuv, poc: int, is_ref: bool = False):
        """Dispatch the device RD pipeline for a B picture
        (rd_b.rd_b_pipeline): list 0 from the past references, list 1
        the nearest future anchor, whose colocated snapshot is translated
        into this list 0.  A stored B (`is_ref`, the pyramid's middle)
        also makes its reference entry."""
        cfg, sps, pps = self.cfg, self.sps, self.pps
        H, W = sps.height, sps.width
        if is_ref:
            # stored mid-B of the pyramid: smaller offset than leaf Bs
            qp = cfg.qp + max(1, cfg.qp_b_offset - 1)
        else:
            qp = cfg.qp + cfg.qp_b_offset
        cb_off, _ = pps.chroma_qp_offset
        qp_c = chroma_qp(qp, cb_off)
        dev = self.device
        cur = tuple(RD._to_i32(np.ascontiguousarray(p, np.uint8), dev)
                    for p in yuv)
        past = sorted((e for e in self._rd_refs if e[0] < poc),
                      key=lambda e: -e[0])
        fut = sorted((e for e in self._rd_refs if e[0] > poc),
                     key=lambda e: e[0])
        if not (past and fut):
            raise RuntimeError(f"B picture {poc} needs anchors on both sides")
        fut_e = fut[0]
        if cfg.b_hierarchy and is_ref:
            # stored mid-B: the longest prefix of the default (POC-desc)
            # past list still inside the sliding window when the leaf Bs
            # decode (then this B + the newest num_ref_frames + 1 of
            # today's refs), so its motion stays mappable for the leaves'
            # temporal direct
            alive = {e[0] for e in
                     self._rd_refs[: max(1, cfg.num_ref_frames) + 1]}
            lst0 = []
            for e in past:
                if e[0] not in alive:
                    break
                lst0.append(e)
            lst0 = lst0 or past[:1]
            nr_max = sps.num_ref_frames
        elif cfg.b_hierarchy:
            # the default B list 0 the decoder builds: every short-term
            # ref, past (POC desc) then future (POC asc); only the tail
            # may be cut, so every colocated reference stays mappable
            lst0 = past + fut
            nr_max = sps.num_ref_frames
        else:
            lst0 = past[: max(1, cfg.num_ref_frames)]
            nr_max = max(1, cfg.num_ref_frames)
        lst0 = lst0[:nr_max]
        pad_n = nr_max - len(lst0)
        banks0 = torch.stack([e[1] for e in lst0 + [lst0[-1]] * pad_n])
        cpads0 = torch.stack([e[2] for e in lst0 + [lst0[-1]] * pad_n])
        banks1 = fut_e[1][None]
        cpads1 = fut_e[2][None]
        col_intra4, col_ref4, col_mvx4, col_mvy4 = fut_e[3]
        pocs0 = [e[0] for e in lst0]
        poc1 = fut_e[0]
        # the colocated picture's ref indices map into ITS list 0 (the
        # anchor's pocs at its encode time): translate into this list 0.
        # Stored Bs never code direct modes, so they skip the mapping.
        if not is_ref:
            anchor_pocs = self._anchor_ref_pocs.get(poc1, pocs0)
            trans = []
            for p0 in anchor_pocs:
                if p0 not in pocs0:
                    raise RuntimeError(
                        f"temporal direct: colocated ref poc {p0} not in B "
                        f"list0 {pocs0}")
                trans.append(pocs0.index(p0))
            if trans:
                tt = torch.tensor(trans, dtype=torch.int32, device=dev)
                col_ref4 = tt[col_ref4.clamp(0, len(trans) - 1).long()]
        dsf = [dist_scale_factor(poc, p0, poc1) if p0 != poc1 else 0
               for p0 in pocs0]
        eq = [p0 == poc1 for p0 in pocs0]
        lam = b_lambda_fx(qp, is_ref)  # the search uses it as is
        out = RDB.rd_b_pipeline(
            *cur, banks0, cpads0, banks1, cpads1,
            col_intra4, col_ref4, col_mvx4, col_mvy4,
            pocs0 + [pocs0[-1]] * pad_n, dsf + [dsf[-1]] * pad_n,
            eq + [eq[-1]] * pad_n, poc1, H=H, W=W,
            R=min(cfg.search_range, 28), qp=qp, qp_c=qp_c, lam=lam,
            lam_me=lam, nref0=len(lst0), make_ref=is_ref, device=dev,
            k=self._b_kernels)
        frame_num = self.frame_num
        if is_ref:
            self.frame_num += 1
            self._rd_refs = ([(poc,) + tuple(out[2])] + self._rd_refs)[
                : sps.num_ref_frames]
            # colocated snapshot index space: its list 0 + [poc1] (index
            # len(list 0) is the sentinel of L1-only blocks)
            self._anchor_ref_pocs[poc] = pocs0 + [poc1]
        # a non-reference B takes the frame_num of the preceding
        # reference picture + 1, the current count
        return (out[0], out[1], poc, pocs0, poc1, qp, frame_num, is_ref)

    def _finish_b_rd(self, pending, fetched) -> list[NalUnit]:
        """Host tail of a dispatched B picture: split its fetched flat
        outputs (the 14 parts of rd_b's host_out), fill the parse state
        and entropy-code the slice."""
        (_, recon, poc, pocs0, poc1, qp, frame_num, is_ref) = pending
        sps, pps = self.sps, self.pps
        W, H = sps.pic_width_in_mbs, sps.frame_height_in_mbs
        n_mb = W * H
        st = PictureParseState(W, H)
        planes = Planes(sps)
        st.slice_id[:] = 0
        st.qp[:] = qp
        cb_off, cr_off = pps.chroma_qp_offset
        st.qpc[:, 0] = chroma_qp(qp, cb_off)
        st.qpc[:, 1] = chroma_qp(qp, cr_off)
        sizes = [n_mb, 4 * n_mb, 4 * n_mb, 4 * n_mb, 4 * n_mb, 4 * n_mb,
                 4 * n_mb, n_mb, n_mb, 256 * n_mb, 16 * n_mb, 128 * n_mb,
                 8 * n_mb, 16 * n_mb]
        parts = np.split(fetched[: sum(sizes)], np.cumsum(sizes)[:-1])
        win = parts[0]
        pdir8, idx0, m0x, m0y, m1x, m1y = (parts[k].reshape(n_mb, 4)
                                           for k in range(1, 7))
        i16mode = parts[7]
        cip = parts[8]
        lev = parts[9].reshape(n_mb, 4, 4, 4, 4)
        dc = parts[10].reshape(n_mb, 4, 4)
        levc = parts[11].reshape(n_mb, 2, 2, 2, 4, 4)
        dcc = parts[12].reshape(n_mb, 2, 2, 2)
        ipm_plane = parts[13].reshape(4 * H, 4 * W)
        planes.Y, planes.U, planes.V = (x.cpu().numpy() for x in recon)
        self._fill_b_state_rd(st, win, pdir8, idx0, m0x, m0y, m1x, m1y,
                              i16mode, cip, lev, dc, levc, dcc, poc,
                              pocs0, poc1, ipm_plane)
        sh = SliceHeader(
            slice_type_code=SliceType.B.value,
            frame_num=frame_num % sps.max_frame_num,
            is_idr=False,
            nal_ref_idc=3 if is_ref else 0,
            pic_order_cnt_lsb=self._poc_lsb(poc),
            direct_spatial_mv_pred_flag=False,
            num_ref_idx_active_override_flag=True,
            num_ref_idx_l0_active_minus1=len(pocs0) - 1,
            num_ref_idx_l1_active_minus1=0,
            slice_qp_delta=qp - (26 + pps.pic_init_qp_minus26),
        )
        w = write_slice_header(sh, sps, pps)
        self._write_slice_data(w, st, sh, list(range(n_mb)))
        if is_ref:
            # stored B: later Bs read its parse state as colocated
            self.recon_pics = (self.recon_pics + [(poc, planes, st, None)])[
                -sps.num_ref_frames:]
        self.all_recons.append((poc, planes))
        self._log_picture("B", poc, fetched)
        return [NalUnit(1, 3 if is_ref else 0, w.get_bytes())]

    def _fill_b_state_rd(self, st, win, pdir8, idx0, m0x, m0y, m1x, m1y,
                         i16mode, cip, lev, dc, levc, dcc, poc, pocs0,
                         poc1, ipm_plane):
        """Decode-state fill of a B picture from its interchange buffer:
        mb types and per-unit prediction directions, residuals and cbp,
        both lists' motion, temporal direct from the anchor's parse state
        (decoder semantics) and the mvds of explicit partitions."""
        n_mb = st.n_mbs
        n_my, n_mx = st.H, st.W
        NONE = -(10 ** 9)
        i4 = win == RD.B_I4
        i16 = win == RD.B_I16
        intra = i16 | i4
        direct = (win == RD.B_DIRECT) | (win == RD.B_DIRECT_ZERO)
        h168 = win == RD.B_L0_16x8
        h816 = win == RD.B_L0_8x16
        p8 = win == RD.B_P8X8
        st.ipredmode[:] = ipm_plane.reshape(4 * n_my, 4 * n_mx)
        st.is_intra[:] = intra
        st.i16mode[:] = np.where(i16, i16mode, -1)
        st.c_ipred_mode[:] = np.where(intra, cip, 0)
        st.mb_type[:] = np.where(
            direct, M.BSKIP_DIRECT,
            np.where(i4, M.I4MB, np.where(i16, M.I16MB,
                     np.where(h168, M.P16x8,
                              np.where(h816, M.P8x16,
                                       np.where(p8, M.P8x8, M.P16x16))))))
        st.b8mode[:] = np.where(
            direct, M.B8_DIRECT,
            np.where(i4, M.IBLOCK, np.where(
                i16, 0, np.where(h168, 2, np.where(h816, 3, 1)))))[:, None]
        pd = np.where(win == RD.B_L0, M.PD_L0,
                      np.where(win == RD.B_L1, M.PD_L1, M.PD_BI))
        st.b8pdir[:] = np.where(intra, M.PD_INTRA, pd)[:, None]
        halves = h168 | h816
        st.b8pdir[halves] = pdir8[halves]
        # P8x8: per-unit sub-mode (pdir8 3 = direct 8x8)
        if p8.any():
            udir = pdir8[p8] == 3
            st.b8mode[p8] = np.where(udir, M.B8_DIRECT, M.B8_8x8)
            st.b8pdir[p8] = np.where(udir, M.PD_BI, pdir8[p8])
        # residuals (the P fill's layout)
        zperm = np.empty(16, np.int64)
        for br in range(4):
            for bc in range(4):
                zperm[int(M.XY_TO_BLK4[br, bc])] = br * 4 + bc
        st.luma_levels[:] = lev.reshape(n_mb, 16, 4, 4)[:, zperm]
        st.luma_dc[:] = np.where(i16[:, None, None], dc, 0)
        st.chroma_levels[:] = levc.reshape(n_mb, 2, 4, 4, 4)
        st.chroma_dc[:] = dcc
        nz4 = lev.any(axis=(3, 4))
        q8 = nz4.reshape(n_mb, 2, 2, 2, 2).any(axis=(2, 4))
        cbp_inter = (q8[:, 0, 0] * 1 + q8[:, 0, 1] * 2 + q8[:, 1, 0] * 4
                     + q8[:, 1, 1] * 8)
        cbp_l = np.where(i16, np.where(nz4.any((1, 2)), 15, 0), cbp_inter)
        has_ac = levc.any(axis=(2, 3, 4, 5)).any(axis=1)
        has_dc = dcc.any(axis=(2, 3)).any(axis=1)
        cbp_c = np.where(has_ac, 2, np.where(has_dc, 1, 0))
        st.cbp[:] = cbp_l + 16 * cbp_c
        weights = (1 << np.arange(16, dtype=np.int64)).reshape(4, 4)
        st.cbp_blk = ((nz4 * weights).sum(axis=(1, 2))
                      | (dc.any(axis=(1, 2)) & i16)).tolist()

        # motion state: explicit first, direct derived after
        def to_pic4(a8):  # (n_mb, 4) per unit -> (4 n_my, 4 n_mx)
            p = (a8.reshape(n_my, n_mx, 2, 2).transpose(0, 2, 1, 3)
                 .reshape(2 * n_my, 2 * n_mx))
            return np.repeat(np.repeat(p, 2, 0), 2, 1)

        use0 = np.isin(win, (RD.B_L0, RD.B_BI))
        use1 = np.isin(win, (RD.B_L1, RD.B_BI))
        # halves and P8x8 carry a per-unit pdir; a direct unit uses both
        hp = halves | p8
        u0_4 = to_pic4(np.where(hp[:, None], (pdir8 == 0) | (pdir8 >= 2),
                                use0[:, None]))
        u1_4 = to_pic4(np.where(hp[:, None], pdir8 >= 1, use1[:, None]))
        poc_of0 = np.asarray(pocs0, np.int64)
        r4 = to_pic4(idx0)
        st.mv[0, ..., 0] = np.where(u0_4, to_pic4(m0x), 0)
        st.mv[0, ..., 1] = np.where(u0_4, to_pic4(m0y), 0)
        st.ref_idx[0] = np.where(u0_4, r4, -1)
        st.ref_pic_id[0] = np.where(
            u0_4, poc_of0[np.clip(r4, 0, len(pocs0) - 1)], NONE)
        st.mv[1, ..., 0] = np.where(u1_4, to_pic4(m1x), 0)
        st.mv[1, ..., 1] = np.where(u1_4, to_pic4(m1y), 0)
        st.ref_idx[1] = np.where(u1_4, 0, -1)
        st.ref_pic_id[1] = np.where(u1_4, poc1, NONE)

        # temporal direct of direct MBs (whole picture, decoder semantics)
        # from the anchor's final parse state, then exact PMV/MVD
        ast = next(e for e in self.recon_pics if e[0] == poc1)[2]
        col = {
            "ref_idx0": ast.ref_idx[0], "ref_idx1": ast.ref_idx[1],
            "ref_id0": ast.ref_pic_id[0], "ref_id1": ast.ref_pic_id[1],
            "mv0": ast.mv[0], "mv1": ast.mv[1],
        }
        inference = bool(self.sps.direct_8x8_inference_flag)
        FL.fill_temporal_direct(st, direct, col, poc, list(pocs0), poc1,
                                inference=inference)
        # per-unit direct 8x8 inside P8x8 MBs: only the masked units
        p8dir = p8[:, None] & (pdir8 == 3)
        if p8dir.any():
            FL.fill_temporal_direct(st, p8dir.any(1), col, poc, list(pocs0),
                                    poc1, inference=inference,
                                    unit_mask=p8dir)
        st.skip_flag[direct & (st.cbp == 0)] = 1
        FL.fill_b_explicit_mvd(st, use0, use1)
        FL.fill_b_half_mvd(st, h168, h816, pdir8)
        FL.fill_b_p8_mvd(st, p8, pdir8)

    def _device_intra_picture(self, st, planes, Y, U, V, qp):
        """Device RD coding of a whole I picture (rd.rd_i_pipeline):
        full-RD I16/I4 mode decisions run on the device; the host keeps
        only the state fill + entropy tail."""
        lam_fx = int(self._lambda_base() * 2.0 ** ((qp - 12) / 3.0) * 65536
                     + 0.5)
        out = RD.rd_i_pipeline(
            np.ascontiguousarray(Y, np.uint8),
            np.ascontiguousarray(U, np.uint8),
            np.ascontiguousarray(V, np.uint8),
            qp=qp, qp_c=int(st.qpc[0, 0]), lam=lam_fx,
            H=self.sps.height, W=self.sps.width, device=self.device,
            impl=self._intra_step)
        (ry, ru, rv, lev, lum_dc, i16mode, cip, levc, dcc, i4flag,
         ipm) = (x.cpu().numpy() for x in out)
        n_mb = st.n_mbs
        i4 = i4flag.astype(bool)
        i16 = ~i4
        st.is_intra[:] = 1
        st.ipredmode[:] = ipm
        st.i16mode[:] = np.where(i16, i16mode, -1)
        st.c_ipred_mode[:] = cip
        st.mb_type[:] = np.where(i4, M.I4MB, M.I16MB)
        st.b8mode[:] = np.where(i4, M.IBLOCK, 0)[:, None]
        st.b8pdir[:] = -1
        zperm = np.empty(16, np.int64)
        for br in range(4):
            for bc in range(4):
                zperm[int(M.XY_TO_BLK4[br, bc])] = br * 4 + bc
        st.luma_levels[:] = lev.reshape(n_mb, 16, 4, 4)[:, zperm]
        st.luma_dc[:] = np.where(i16[:, None, None], lum_dc, 0)
        st.chroma_levels[:] = levc.reshape(n_mb, 2, 4, 4, 4)
        st.chroma_dc[:] = dcc
        nz4 = lev.any(axis=(3, 4))  # (n_mb, br, bc)
        q8 = nz4.reshape(n_mb, 2, 2, 2, 2).any(axis=(2, 4))
        cbp_i4 = (q8[:, 0, 0] * 1 + q8[:, 0, 1] * 2 + q8[:, 1, 0] * 4
                  + q8[:, 1, 1] * 8)
        cbp_l = np.where(i16, np.where(nz4.any((1, 2)), 15, 0), cbp_i4)
        has_ac = levc.any(axis=(2, 3, 4, 5)).any(axis=1)
        has_dc = dcc.any(axis=(2, 3)).any(axis=1)
        cbp_c = np.where(has_ac, 2, np.where(has_dc, 1, 0))
        st.cbp[:] = cbp_l + 16 * cbp_c
        weights = (1 << np.arange(16, dtype=np.int64)).reshape(4, 4)
        cbp_blk = (nz4 * weights).sum(axis=(1, 2))
        dc_any = lum_dc.any(axis=(1, 2)) & i16
        st.cbp_blk = (cbp_blk | dc_any).tolist()
        planes.Y[:] = ry
        planes.U[:] = ru
        planes.V[:] = rv


def b_lambda_fx(qp: int, is_ref: bool) -> int:
    """The B slice's lambda in <<16 fixed point: JM's 0.68 base x
    clip3(2, 4, (qp - 12) / 6) x 0.95 (lencod/src/slice.c:1261), halved
    for a stored B picture; float64 on the host, as the reference."""
    qp_t = qp - 12
    lam_f = 0.68 * 0.95 * 2.0 ** (qp_t / 3.0) * min(4.0, max(2.0, qp_t / 6.0))
    if is_ref:
        lam_f *= 0.5
    return int(lam_f * 65536 + 0.5)


def fetch_group(flats) -> np.ndarray:
    """Flat int32 device outputs of a group of pictures -> one
    (len(flats), max_len) numpy array, zero-padded: one copy into one
    (pinned, on a card) host buffer, so the copy latency is paid once per
    group (the reference's rd.py:1895 `fetch_group`)."""
    n = max(int(f.shape[0]) for f in flats)
    on_card = flats[0].is_cuda
    out = torch.zeros((len(flats), n), dtype=torch.int32, pin_memory=on_card)
    for row, f in zip(out, flats):
        row[: f.shape[0]].copy_(f, non_blocking=on_card)
    if on_card:
        torch.cuda.current_stream(flats[0].device).synchronize()
    return out.numpy()
