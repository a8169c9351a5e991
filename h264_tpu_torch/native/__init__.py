"""Native (C) host runtime, loaded via ctypes: the CABAC and CAVLC slice
writers, the serial CABAC automaton, the deblocking filter, and the decoder's
CABAC/CAVLC slice parsers and full-picture reconstruction.

Built on demand with gcc into ``build/h264_tpu_torch/``; every native
path has a pure Python fallback (its caller's oracle), so a missing
toolchain changes speed, never output.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

from ..device import build_host_c

_DIR = pathlib.Path(__file__).resolve().parent
_libs: dict = {}
_I32P = ctypes.POINTER(ctypes.c_int32)


# libs that link extra translation units (separate TUs: statics stay local)
_EXTRA_SRC = {"recon": ["deblock.c"]}


def _load(stem: str):
    """Build (if stale) and load lib<stem>.so from <stem>.c; None on failure."""
    if stem in _libs:
        return _libs[stem]
    try:
        lib = ctypes.CDLL(str(build_host_c(stem, _DIR,
                                           _EXTRA_SRC.get(stem, ()))))
    except (OSError, subprocess.CalledProcessError):
        lib = None
    _libs[stem] = lib
    return lib


def get_lib():
    """The loaded CABAC native library, or None if unavailable."""
    lib = _load("cabac_engine")
    if lib is not None and not getattr(lib, "_sigs_set", False):
        lib.cabac_encode_run.restype = ctypes.c_long
        lib.cabac_encode_run.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_long,
        ]
        lib._sigs_set = True
    return lib


def compute_strengths(st, field: bool, intra_types):
    """Native boundary-strength precompute (deblock.c compute_strengths);
    returns (BSV, BSH) or None when the lib is unavailable."""
    lib = _load("deblock")
    if lib is None:
        return None
    import numpy as np

    H4, W4 = 4 * st.H, 4 * st.W
    REF_NONE = -(10 ** 9)
    is_intra_mb = np.ascontiguousarray(
        np.isin(st.mb_type, intra_types), np.uint8)
    cbp_blk = np.ascontiguousarray(np.asarray(st.cbp_blk, np.int64))
    rid0 = np.ascontiguousarray(
        np.where(st.ref_idx[0] >= 0, st.ref_pic_id[0], REF_NONE), np.int64)
    rid1 = np.ascontiguousarray(
        np.where(st.ref_idx[1] >= 0, st.ref_pic_id[1], REF_NONE), np.int64)
    mv0 = np.ascontiguousarray(st.mv[0], np.int32)
    mv1 = np.ascontiguousarray(st.mv[1], np.int32)
    BSV = np.empty((H4, W4), np.int32)
    BSH = np.empty((H4, W4), np.int32)

    def p(x):
        return x.ctypes.data_as(ctypes.c_void_p)

    lib.compute_strengths(
        p(is_intra_mb), p(cbp_blk), p(rid0), p(rid1), p(mv0), p(mv1),
        st.W, st.H, int(bool(field)), p(BSV), p(BSH))
    return BSV, BSH


def deblock_run(Y, U, V, BSV, BSH, qp, qpc, lf_disable, lf_alpha, lf_beta,
                transform8x8, slice_id, cfi: int, max_y: int, max_c: int,
                n_mbW: int, n_mbH: int) -> bool:
    """Native full-picture deblock (frame, non-MBAFF, 4:2:0/mono).

    Filters Y/U/V in place; all arrays must be contiguous int32.  Returns
    False if the native library is unavailable (caller uses the oracle)."""
    lib = _load("deblock")
    if lib is None:
        return False
    if not getattr(lib, "_sigs_set", False):
        lib.deblock_run.restype = None
        lib.deblock_run.argtypes = [_I32P] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ] + [_I32P] * 9 + [ctypes.c_int, ctypes.c_int32, ctypes.c_int32]
        lib._sigs_set = True
    import numpy as np

    def p(a):
        if a.dtype != np.int32 or not a.flags.c_contiguous:
            raise ValueError("deblock_run takes contiguous int32 arrays")
        return a.ctypes.data_as(_I32P)

    H_pix, W_pix = Y.shape
    null = ctypes.cast(None, _I32P)
    lib.deblock_run(
        p(Y), p(U) if U is not None else null, p(V) if V is not None else null,
        W_pix, H_pix, n_mbW, n_mbH,
        p(BSV), p(BSH), p(qp), p(qpc), p(lf_disable), p(lf_alpha),
        p(lf_beta), p(transform8x8), p(slice_id), cfi, max_y, max_c,
    )
    return True


_cavlc_tables = None


def _get_cavlc_tables():
    """Flattened int32 copies of the CAVLC code tables (cached)."""
    global _cavlc_tables
    if _cavlc_tables is None:
        import numpy as np

        from ..entropy.cavlc import tables as T

        def arr(x):
            return np.ascontiguousarray(x, np.int32)

        tzc_len = np.zeros((15, 16), np.int32)
        tzc_code = np.zeros((15, 16), np.int32)
        for i, row in enumerate(T.TOTAL_ZEROS_CDC_LEN[0]):
            tzc_len[i, : len(row)] = row
        for i, row in enumerate(T.TOTAL_ZEROS_CDC_CODE[0]):
            tzc_code[i, : len(row)] = row
        cbp_intra = arr([T.NCBP[1][cbp][0] for cbp in range(48)])
        cbp_inter = arr([T.NCBP[1][cbp][1] for cbp in range(48)])
        _cavlc_tables = (
            arr(T.COEFF_TOKEN_LEN), arr(T.COEFF_TOKEN_CODE),
            arr(T.COEFF_TOKEN_CDC_LEN[0]), arr(T.COEFF_TOKEN_CDC_CODE[0]),
            arr(T.TOTAL_ZEROS_LEN), arr(T.TOTAL_ZEROS_CODE),
            tzc_len, tzc_code,
            arr(T.RUN_BEFORE_LEN), arr(T.RUN_BEFORE_CODE),
            cbp_intra, cbp_inter,
        )
    return _cavlc_tables


def cavlc_write_slice(st, is_p: bool, n_ref: int, init_qp: int,
                      constrained_intra: bool, chroma420: bool,
                      mb_addrs, nnz):
    """Native CAVLC slice-data writer.

    Returns (payload_bytes, nbits) or None if unavailable/unsupported.
    `nnz` (int32 [3,4H,4W]) is updated in place (JM nz_coeff semantics)."""
    lib = _load("cavlc_writer")
    if lib is None:
        return None
    import numpy as np

    if not getattr(lib, "_cavlc_sigs", False):
        lib.cavlc_write_slice.restype = ctypes.c_long
        lib._cavlc_sigs = True

    def a(x, dtype=np.int32):
        return np.ascontiguousarray(x, dtype)

    def p(x):
        return x.ctypes.data_as(_I32P)

    tabs = _get_cavlc_tables()
    mb_addrs = a(mb_addrs)
    n_mbs = st.n_mbs
    cap_bytes = 1024 * n_mbs + 4096
    out = ctypes.create_string_buffer(cap_bytes)
    # keep temporaries alive through the call
    arrs = [
        a(st.mb_type), a(st.skip_flag), a(st.cbp), a(st.qp),
        a(st.c_ipred_mode), a(st.b8mode), a(st.i16mode), a(st.is_intra),
        a(st.slice_id), a(st.ipredmode), a(st.ref_idx[0]), a(st.mvd[0]),
        a(st.luma_levels), a(st.luma_dc), a(st.chroma_dc),
        a(st.chroma_levels),
    ]
    if nnz.dtype != np.int32 or not nnz.flags.c_contiguous:
        raise ValueError("cavlc_write_slice: nnz must be contiguous int32")
    nbits = lib.cavlc_write_slice(
        st.W, st.H,
        *(p(x) for x in arrs),
        int(is_p), int(n_ref), int(init_qp), int(constrained_intra),
        int(chroma420), p(mb_addrs), len(mb_addrs),
        *(p(x) for x in tabs),
        p(nnz), ctypes.cast(out, ctypes.c_char_p), ctypes.c_long(8 * cap_bytes),
    )
    if nbits < 0:
        return None
    return out.raw[: (nbits + 7) // 8], nbits


_cabac_tabs = None


def _get_cabac_tabs():
    """Flattened int32 residual-coding tables for the native writer."""
    global _cabac_tabs
    if _cabac_tabs is None:
        import numpy as np

        from ..decoder import mbtables as M
        from ..entropy.cabac import tables as T

        p2c_map = np.zeros((22, 64), np.int32)
        p2c_last = np.zeros((22, 64), np.int32)
        for t in range(22):
            p2c_map[t, : len(T.POS2CTX_MAP[t])] = T.POS2CTX_MAP[t]
            p2c_last[t, : len(T.POS2CTX_LAST[t])] = T.POS2CTX_LAST[t]
        t2c = np.stack(
            [T.TYPE2CTX_BCBP, T.TYPE2CTX_MAP, T.TYPE2CTX_LAST, T.TYPE2CTX_ONE,
             T.TYPE2CTX_ABS, T.MAXPOS, T.C1ISDC, T.MAX_C2]
        ).astype(np.int32)
        zz4 = np.ascontiguousarray(
            M.ZZ_SCAN_4x4[:, 1] * 4 + M.ZZ_SCAN_4x4[:, 0], np.int32
        )
        zz8 = np.ascontiguousarray(
            M.ZZ_SCAN_8x8[:, 1] * 8 + M.ZZ_SCAN_8x8[:, 0], np.int32
        )
        _cabac_tabs = (
            np.ascontiguousarray(p2c_map), np.ascontiguousarray(p2c_last),
            np.ascontiguousarray(t2c), zz4, zz8,
        )
    return _cabac_tabs


def cabac_write_slice(st, slice_type: int, init_qp: int, n_ref0: int,
                      n_ref1: int, t8_mode: bool, constrained_intra: bool,
                      chroma_format_idc: int, mb_addrs,
                      states: bytearray, mps: bytearray):
    """Native CABAC slice-data writer (binarize + arithmetic in one pass).

    slice_type: 0=P, 1=B, 2=I.  Returns payload bytes, or None when the
    native lib is unavailable or the state needs the Python oracle."""
    lib = _load("cabac_writer")
    if lib is None or chroma_format_idc not in (0, 1):
        return None
    import numpy as np

    if not getattr(lib, "_writer_sigs", False):
        lib.cabac_write_slice.restype = ctypes.c_long
        lib._writer_sigs = True

    def a(x, dtype=np.int32):
        return np.ascontiguousarray(x, dtype)

    def p(x):
        return x.ctypes.data_as(ctypes.c_void_p)

    tabs = _get_cabac_tabs()
    mb_addrs = a(mb_addrs)
    arrs = [
        a(st.mb_type), a(st.skip_flag, np.uint8), a(st.cbp), a(st.qp),
        a(st.c_ipred_mode), a(st.b8mode), a(st.b8pdir), a(st.i16mode),
        a(st.is_intra, np.uint8), a(st.transform8x8, np.uint8),
        a(st.slice_id), a(st.ipredmode, np.int8), a(st.ref_idx, np.int8),
        a(st.mvd), a(st.luma_levels), a(st.luma8_levels), a(st.luma_dc),
        a(st.chroma_dc), a(st.chroma_levels),
    ]
    cbp_bits = np.zeros(st.n_mbs, np.int64)
    cap_bits = 8 * (1024 * len(mb_addrs) + 65536)
    out = ctypes.create_string_buffer(cap_bits // 8)
    st_buf = ctypes.create_string_buffer(bytes(states), len(states))
    mps_buf = ctypes.create_string_buffer(bytes(mps), len(mps))
    nbits = lib.cabac_write_slice(
        st.W, st.H,
        *(p(x) for x in arrs),
        int(slice_type), int(init_qp), int(n_ref0), int(n_ref1),
        int(t8_mode), int(constrained_intra), int(chroma_format_idc),
        p(mb_addrs), len(mb_addrs),
        *(p(x) for x in tabs),
        ctypes.cast(st_buf, ctypes.c_char_p),
        ctypes.cast(mps_buf, ctypes.c_char_p),
        p(cbp_bits),
        ctypes.cast(out, ctypes.c_char_p), ctypes.c_long(cap_bits),
    )
    if nbits < 0:
        return None
    if nbits % 8:
        raise RuntimeError("CABAC payload must end byte-aligned")
    return out.raw[: nbits // 8]


def cabac_parse_slice(st, rbsp: bytes, sh, sps, pps, slice_id: int,
                      fmo_next=None):
    """Native CABAC slice-data parser (arithmetic + de-binarization in
    one pass); the decode dual of cabac_write_slice.

    Fills the PictureParseState arrays in place for every MB of the
    slice.  Returns the list of parsed MB addresses, or None when the
    native lib is unavailable or the stream needs the Python oracle
    (fields/MBAFF, high bit depth, 4:2:2+)."""
    lib = _load("cabac_reader")
    if lib is None:
        return None
    import numpy as np

    from ..entropy.cabac.engine import ContextSet
    from ..syntax.slice_header import SliceType

    if sps.chroma_format_idc not in (0, 1) or sps.bit_depth_luma != 8:
        return None
    if sh.field_pic_flag or sps.mb_adaptive_frame_field_flag:
        return None
    if not getattr(lib, "_reader_sigs", False):
        lib.cabac_parse_slice.restype = ctypes.c_long
        lib._reader_sigs = True

    stype = sh.slice_type
    type_code = {SliceType.P: 0, SliceType.B: 1, SliceType.I: 2}.get(stype)
    if type_code is None:
        return None
    qp = sh.slice_qp(pps)
    ctx = ContextSet(stype in (SliceType.I, SliceType.SI),
                     sh.cabac_init_idc, qp)

    def p(x):
        return x.ctypes.data_as(ctypes.c_void_p)

    def a(x, dtype):
        arr = np.ascontiguousarray(x, dtype)
        assert arr.flags.c_contiguous
        return arr

    tabs = _get_cabac_tabs()
    nb = st.n_mbs
    # writable views/copies of the state arrays; non-contiguous or
    # list-typed fields go through staging buffers
    cbp_bits = np.asarray(st.cbp_bits, np.int64)
    cbp_blk = np.asarray(st.cbp_blk, np.int64)
    next_addr = None
    next_p = ctypes.cast(None, ctypes.c_void_p)
    if fmo_next is not None:
        next_addr = a(fmo_next, np.int32)
        next_p = p(next_addr)
    ipcm_cap = nb
    ipcm_data = np.zeros((ipcm_cap, 384), np.uint8)
    ipcm_addrs = np.zeros(ipcm_cap, np.int32)
    n_ipcm = ctypes.c_int32(0)
    arrs = {
        "mb_type": a(st.mb_type, np.int32),
        "raw_mb_type": a(st.raw_mb_type, np.int32),
        "skip_flag": a(st.skip_flag, np.uint8),
        "cbp": a(st.cbp, np.int32),
        "qp": a(st.qp, np.int32),
        "c_ipred_mode": a(st.c_ipred_mode, np.int32),
        "b8mode": a(st.b8mode, np.int32),
        "b8pdir": a(st.b8pdir, np.int32),
        "i16mode": a(st.i16mode, np.int32),
        "is_intra": a(st.is_intra, np.uint8),
        "transform8x8": a(st.transform8x8, np.uint8),
        "slice_id": a(st.slice_id, np.int32),
        "ipredmode": a(st.ipredmode, np.int8),
        "ref_idx": a(st.ref_idx, np.int8),
        "mvd": a(st.mvd, np.int32),
        "luma_levels": a(st.luma_levels, np.int32),
        "luma8_levels": a(st.luma8_levels, np.int32),
        "luma_dc": a(st.luma_dc, np.int32),
        "chroma_dc": a(st.chroma_dc, np.int32),
        "chroma_levels": a(st.chroma_levels, np.int32),
        "nnz": a(st.nnz, np.uint8),
    }
    start_bit = (sh.header_bit_len + 7) & ~7
    buf = ctypes.create_string_buffer(rbsp, len(rbsp))
    states = ctypes.create_string_buffer(bytes(ctx.states), len(ctx.states))
    mps = ctypes.create_string_buffer(bytes(ctx.mps), len(ctx.mps))
    n = lib.cabac_parse_slice(
        st.W, st.H,
        p(arrs["mb_type"]), p(arrs["raw_mb_type"]), p(arrs["skip_flag"]),
        p(arrs["cbp"]), p(cbp_bits), p(cbp_blk),
        p(arrs["qp"]), p(arrs["c_ipred_mode"]), p(arrs["b8mode"]),
        p(arrs["b8pdir"]), p(arrs["i16mode"]), p(arrs["is_intra"]),
        p(arrs["transform8x8"]), p(arrs["slice_id"]), p(arrs["ipredmode"]),
        p(arrs["ref_idx"]), p(arrs["mvd"]), p(arrs["luma_levels"]),
        p(arrs["luma8_levels"]), p(arrs["luma_dc"]), p(arrs["chroma_dc"]),
        p(arrs["chroma_levels"]), p(arrs["nnz"]),
        int(type_code), int(qp),
        int(sh.num_ref_idx_l0_active_minus1 + 1),
        int(sh.num_ref_idx_l1_active_minus1 + 1),
        int(bool(pps.transform_8x8_mode_flag)),
        int(bool(pps.constrained_intra_pred_flag)),
        int(sps.chroma_format_idc),
        int(bool(sps.direct_8x8_inference_flag)),
        int(sh.first_mb_in_slice), int(slice_id), next_p,
        ctypes.cast(buf, ctypes.c_char_p), ctypes.c_long(8 * len(rbsp)),
        ctypes.c_long(start_bit),
        p(tabs[0]), p(tabs[1]), p(tabs[2]), p(tabs[3]), p(tabs[4]),
        ctypes.cast(states, ctypes.c_char_p),
        ctypes.cast(mps, ctypes.c_char_p),
        p(ipcm_data), p(ipcm_addrs), ipcm_cap, ctypes.byref(n_ipcm),
    )
    if n < 0:
        raise ValueError("native CABAC parse failed (corrupt slice data)")
    # write back staged outputs (a() returns the state array itself when
    # dtype/layout already match, so this usually copies nothing)
    for name, arr in arrs.items():
        dst = getattr(st, name)
        if dst is not arr:
            np.copyto(dst, arr.reshape(dst.shape).astype(dst.dtype))
    st.cbp_bits = [int(v) for v in cbp_bits]
    st.cbp_blk = [int(v) for v in cbp_blk]
    import numpy as _np

    for k in range(int(n_ipcm.value)):
        addr = int(ipcm_addrs[k])
        blob = ipcm_data[k]
        luma = blob[:256].reshape(16, 16).astype(_np.int32)
        if sps.chroma_format_idc == 1:
            cb = blob[256:320].reshape(8, 8).astype(_np.int32)
            cr = blob[320:384].reshape(8, 8).astype(_np.int32)
            st.ipcm_samples[addr] = (luma, cb, cr)
        else:
            st.ipcm_samples[addr] = (luma,)
    # per-MB slice-level fields (the Python parser fills these per MB)
    mask = np.asarray(st.slice_id) == slice_id
    st.lf_disable[mask] = sh.disable_deblocking_filter_idc
    st.lf_alpha[mask] = 2 * sh.slice_alpha_c0_offset_div2
    st.lf_beta[mask] = 2 * sh.slice_beta_offset_div2
    from ..ops.exact import chroma_qp_vec as _cqpv

    cb_off, cr_off = pps.chroma_qp_offset
    qps = np.asarray(st.qp)[mask]
    st.qpc[mask, 0] = _cqpv(qps, cb_off)
    st.qpc[mask, 1] = _cqpv(qps, cr_off)
    return int(n)


def cavlc_parse_slice(st, rbsp: bytes, sh, sps, pps, slice_id: int,
                      fmo_next=None):
    """Native CAVLC slice-data parser (native/cavlc_reader.c); the decode
    dual of cavlc_write_slice.  Returns the parsed-MB count or None when
    the oracle must run (DP, 4:2:2+, high bit depth, fields)."""
    lib = _load("cavlc_reader")
    if lib is None:
        return None
    import numpy as np

    from ..syntax.slice_header import SliceType

    if sps.chroma_format_idc != 1 or sps.bit_depth_luma != 8:
        return None
    if sh.field_pic_flag or sh.is_dp:
        return None
    type_code = {SliceType.P: 0, SliceType.B: 1, SliceType.I: 2}.get(
        sh.slice_type)
    if type_code is None:
        return None
    if not getattr(lib, "_creader_sigs", False):
        lib.cavlc_parse_slice.restype = ctypes.c_long
        lib._creader_sigs = True

    def p(x):
        return x.ctypes.data_as(ctypes.c_void_p)

    def a(x, dtype):
        arr = np.ascontiguousarray(x, dtype)
        assert arr.flags.c_contiguous
        return arr

    ctabs = _get_cavlc_tables()
    zz = _get_cabac_tabs()  # zz4 / zz8 raster maps
    nb = st.n_mbs
    cbp_blk = np.asarray(st.cbp_blk, np.int64)
    next_p = ctypes.cast(None, ctypes.c_void_p)
    next_arr = None
    if fmo_next is not None:
        next_arr = a(fmo_next, np.int32)
        next_p = p(next_arr)
    ipcm_data = np.zeros((nb, 384), np.uint8)
    ipcm_addrs = np.zeros(nb, np.int32)
    n_ipcm = ctypes.c_int32(0)
    arrs = {
        "mb_type": a(st.mb_type, np.int32),
        "raw_mb_type": a(st.raw_mb_type, np.int32),
        "skip_flag": a(st.skip_flag, np.uint8),
        "cbp": a(st.cbp, np.int32),
        "qp": a(st.qp, np.int32),
        "c_ipred_mode": a(st.c_ipred_mode, np.int32),
        "b8mode": a(st.b8mode, np.int32),
        "b8pdir": a(st.b8pdir, np.int32),
        "i16mode": a(st.i16mode, np.int32),
        "is_intra": a(st.is_intra, np.uint8),
        "transform8x8": a(st.transform8x8, np.uint8),
        "slice_id": a(st.slice_id, np.int32),
        "ipredmode": a(st.ipredmode, np.int8),
        "ref_idx": a(st.ref_idx, np.int8),
        "mvd": a(st.mvd, np.int32),
        "luma_levels": a(st.luma_levels, np.int32),
        "luma8_levels": a(st.luma8_levels, np.int32),
        "luma_dc": a(st.luma_dc, np.int32),
        "chroma_dc": a(st.chroma_dc, np.int32),
        "chroma_levels": a(st.chroma_levels, np.int32),
        "nnz": a(st.nnz, np.uint8),
    }
    buf = ctypes.create_string_buffer(rbsp, len(rbsp))
    n = lib.cavlc_parse_slice(
        st.W, st.H,
        p(arrs["mb_type"]), p(arrs["raw_mb_type"]), p(arrs["skip_flag"]),
        p(arrs["cbp"]), p(cbp_blk),
        p(arrs["qp"]), p(arrs["c_ipred_mode"]), p(arrs["b8mode"]),
        p(arrs["b8pdir"]), p(arrs["i16mode"]), p(arrs["is_intra"]),
        p(arrs["transform8x8"]), p(arrs["slice_id"]), p(arrs["ipredmode"]),
        p(arrs["ref_idx"]), p(arrs["mvd"]), p(arrs["luma_levels"]),
        p(arrs["luma8_levels"]), p(arrs["luma_dc"]), p(arrs["chroma_dc"]),
        p(arrs["chroma_levels"]), p(arrs["nnz"]),
        int(type_code), int(sh.slice_qp(pps)),
        int(sh.num_ref_idx_l0_active_minus1 + 1),
        int(sh.num_ref_idx_l1_active_minus1 + 1),
        int(bool(pps.transform_8x8_mode_flag)),
        int(bool(pps.constrained_intra_pred_flag)),
        int(sps.chroma_format_idc),
        int(bool(sps.direct_8x8_inference_flag)),
        int(sh.first_mb_in_slice), int(slice_id), next_p,
        ctypes.cast(buf, ctypes.c_char_p), ctypes.c_long(len(rbsp)),
        ctypes.c_long(sh.header_bit_len),
        p(ctabs[0]), p(ctabs[1]), p(ctabs[2]), p(ctabs[3]),
        p(ctabs[4]), p(ctabs[5]), p(ctabs[6]), p(ctabs[7]),
        p(ctabs[8]), p(ctabs[9]), p(ctabs[10]), p(ctabs[11]),
        p(zz[3]), p(zz[4]),
        p(ipcm_data), p(ipcm_addrs), st.n_mbs, ctypes.byref(n_ipcm),
    )
    if n < 0:
        raise ValueError("native CAVLC parse failed (corrupt slice data)")
    for name, arr in arrs.items():
        dst = getattr(st, name)
        if dst is not arr:
            np.copyto(dst, arr.reshape(dst.shape).astype(dst.dtype))
    st.cbp_blk = [int(v) for v in cbp_blk]
    for k in range(int(n_ipcm.value)):
        addr = int(ipcm_addrs[k])
        blob = ipcm_data[k]
        luma = blob[:256].reshape(16, 16).astype(np.int32)
        cb = blob[256:320].reshape(8, 8).astype(np.int32)
        cr = blob[320:384].reshape(8, 8).astype(np.int32)
        st.ipcm_samples[addr] = (luma, cb, cr)
    mask = np.asarray(st.slice_id) == slice_id
    st.lf_disable[mask] = sh.disable_deblocking_filter_idc
    st.lf_alpha[mask] = 2 * sh.slice_alpha_c0_offset_div2
    st.lf_beta[mask] = 2 * sh.slice_beta_offset_div2
    from ..ops.exact import chroma_qp_vec as _cqpv

    cb_off, cr_off = pps.chroma_qp_offset
    qps = np.asarray(st.qp)[mask]
    st.qpc[mask, 0] = _cqpv(qps, cb_off)
    st.qpc[mask, 1] = _cqpv(qps, cr_off)
    return int(n)


_MAXREF = 32


_recon_bufs: dict = {}


def recon_picture(st, sps, pps, planes, slice_info, slice_refs, slice_wp,
                  slice_cadj=None, deblock=False):
    """Native full-picture reconstruction (MV derivation + MC + intra +
    residuals); the runtime dual of decoder/recon.py + decoder/mv.py.

    Returns truthy when the picture was reconstructed (planes filled,
    st.mv / st.ref_idx / st.ref_pic_id finalized); False -> caller uses
    the Python oracle.  With deblock=True the in-loop filter also runs
    inside the same native call when possible — then the return value
    is 2 and the caller must skip its own deblock pass."""
    lib = _load("recon")
    if lib is None:
        return False
    import numpy as np

    if sps.chroma_format_idc != 1 or sps.bit_depth_luma != 8:
        return False
    if st.ipcm_samples:
        return False
    if (np.asarray(st.slice_id) < 0).any():
        return False  # missing MBs: ERC path stays on the oracle
    NS = len(slice_info)
    if NS == 0:
        return False
    from ..syntax.slice_header import SliceType

    tcode = {SliceType.P: 0, SliceType.B: 1, SliceType.I: 2,
             SliceType.SP: None, SliceType.SI: None}
    from ..syntax.parsets import effective_scaling

    ws = effective_scaling(sps, pps)
    if ws is None:
        ws4 = np.zeros((6, 16), np.int32)
        ws8 = np.zeros((2, 64), np.int32)
        has_ws = 0
    else:
        ws4 = np.ascontiguousarray(
            np.asarray(ws[0], np.int32).reshape(6, 16))
        ws8 = np.ascontiguousarray(
            np.asarray(ws[1], np.int32).reshape(2, 64))
        has_ws = 1

    W4, H4 = 4 * st.W, 4 * st.H
    any_col = any(info.get("col") is not None for info in slice_info)

    def _buf(key, shape, dtype, fill):
        """Pooled staging buffer (these are rebuilt every picture; the
        pool removes ~2 MB/picture of allocation churn).  fill=None
        leaves contents undefined — callers must overwrite or gate the
        native read (s_has_col)."""
        arr = _recon_bufs.get(key)
        if arr is None or arr.shape != shape or arr.dtype != np.dtype(
                dtype):
            arr = np.empty(shape, dtype)
            _recon_bufs[key] = arr
        if fill is not None:
            arr.fill(fill)
        return arr

    s_type = _buf("s_type", (NS,), np.int32, 0)
    s_spatial = _buf("s_spatial", (NS,), np.int32, 0)
    s_d8x8 = _buf("s_d8x8", (NS,), np.int32, 0)
    s_nref = _buf("s_nref", (NS, 2), np.int32, 0)
    s_refids = _buf("s_refids", (NS, 2, _MAXREF), np.int64, 0)
    s_reflt = _buf("s_reflt", (NS, 2, _MAXREF), np.uint8, 0)
    s_curpoc = _buf("s_curpoc", (NS,), np.int32, 0)
    s_colpoc = _buf("s_colpoc", (NS,), np.int32, 0)
    s_has_col = _buf("s_has_col", (NS,), np.int32, 0)
    cfill = 0 if any_col else None  # unread when s_has_col == 0
    col_moving = _buf("col_moving", (NS, H4, W4), np.uint8, cfill)
    col_ref0 = _buf("col_ref0", (NS, H4, W4), np.int8,
                    -1 if any_col else None)
    col_ref1 = _buf("col_ref1", (NS, H4, W4), np.int8,
                    -1 if any_col else None)
    col_id0 = _buf("col_id0", (NS, H4, W4), np.int64, cfill)
    col_id1 = _buf("col_id1", (NS, H4, W4), np.int64, cfill)
    col_mv0 = _buf("col_mv0", (NS, H4, W4, 2), np.int32, cfill)
    col_mv1 = _buf("col_mv1", (NS, H4, W4, 2), np.int32, cfill)
    wp_mode = _buf("wp_mode", (NS,), np.int32, 0)
    wp_ly = _buf("wp_ly", (NS,), np.int32, 5)
    wp_lc = _buf("wp_lc", (NS,), np.int32, 5)
    wy = _buf("wy", (NS, 2, _MAXREF), np.int32, 32)
    oyt = _buf("oyt", (NS, 2, _MAXREF), np.int32, 0)
    wct = _buf("wct", (NS, 2, _MAXREF, 2), np.int32, 32)
    oct_ = _buf("oct_", (NS, 2, _MAXREF, 2), np.int32, 0)
    wimp = _buf("wimp", (NS, _MAXREF, _MAXREF, 2), np.int32, 32)
    cadj = _buf("cadj", (NS, 2, _MAXREF), np.int32, 0)
    if slice_cadj is not None:
        for sid, lsts in enumerate(slice_cadj):
            for lst in (0, 1):
                for ri, v in enumerate(lsts[lst][:_MAXREF]):
                    cadj[sid, lst, ri] = v
    PTR = ctypes.POINTER(ctypes.c_int32)
    refY = (PTR * (NS * 2 * _MAXREF))()
    refU = (PTR * (NS * 2 * _MAXREF))()
    refV = (PTR * (NS * 2 * _MAXREF))()
    keep = []  # keep padded planes alive

    for sid, info in enumerate(slice_info):
        tc = tcode.get(info["type"])
        if tc is None:
            return False
        s_type[sid] = tc
        s_spatial[sid] = int(bool(info.get("spatial_direct", True)))
        s_d8x8[sid] = int(bool(info.get("direct_8x8_inference", True)))
        s_curpoc[sid] = int(info.get("cur_poc", 0))
        for lst in (0, 1):
            ids = info["ref_ids"][lst]
            if len(ids) > _MAXREF:
                return False
            s_nref[sid, lst] = len(ids)
            for ri, v in enumerate(ids):
                s_refids[sid, lst, ri] = int(v)
            lts = info.get("ref_lt", [[], []])[lst]
            for ri, v in enumerate(lts[:_MAXREF]):
                s_reflt[sid, lst, ri] = int(bool(v))
            for ri, (Yp, Up, Vp) in enumerate(slice_refs[sid][lst]):
                for arr, tab in ((Yp, refY), (Up, refU), (Vp, refV)):
                    a = np.ascontiguousarray(arr, np.int32)
                    keep.append(a)
                    tab[(sid * 2 + lst) * _MAXREF + ri] = a.ctypes.data_as(
                        PTR)
        col = info.get("col")
        if col is not None:
            s_has_col[sid] = 1
            s_colpoc[sid] = int(col.get("poc", 0))
            if col.get("moving") is not None:
                col_moving[sid] = np.asarray(col["moving"], np.uint8)
            if "ref_idx0" in col:
                col_ref0[sid] = np.asarray(col["ref_idx0"], np.int8)
                col_ref1[sid] = np.asarray(col["ref_idx1"], np.int8)
                col_id0[sid] = np.asarray(col["ref_id0"], np.int64)
                col_id1[sid] = np.asarray(col["ref_id1"], np.int64)
                col_mv0[sid] = np.asarray(col["mv0"], np.int32)
                col_mv1[sid] = np.asarray(col["mv1"], np.int32)
        wp = slice_wp[sid]
        if wp is not None:
            wp_mode[sid] = wp["mode"]
            wp_ly[sid] = wp["ly"]
            wp_lc[sid] = wp["lc"]
            if wp["mode"] == 1:
                for lst in (0, 1):
                    for ri, pw in enumerate(wp["w"][lst][:_MAXREF]):
                        wy[sid, lst, ri] = pw.luma_weight
                        oyt[sid, lst, ri] = pw.luma_offset
                        wct[sid, lst, ri] = pw.chroma_weight
                        oct_[sid, lst, ri] = pw.chroma_offset
            else:
                for (i, j), (w0, w1) in wp["tab"].items():
                    if i < _MAXREF and j < _MAXREF:
                        wimp[sid, i, j] = (w0, w1)

    if not getattr(lib, "_recon_sigs", False):
        lib.recon_picture.restype = ctypes.c_long
        lib.recon_and_deblock.restype = ctypes.c_long
        lib._recon_sigs = True
    fused = deblock and not getattr(sps, "is_field_picture", False)

    def a(x, dtype):
        arr = np.ascontiguousarray(x, dtype)
        keep.append(arr)
        return arr

    def p(x):
        return x.ctypes.data_as(ctypes.c_void_p)

    from ..ops.interp import PAD

    mv = a(st.mv, np.int32)
    ref_idx = a(st.ref_idx, np.int8)
    rpid = a(st.ref_pic_id, np.int64)
    Yp = a(planes.Y, np.int32)
    Up = a(planes.U, np.int32)
    Vp = a(planes.V, np.int32)
    args = (
        st.W, st.H, sps.width, sps.height, PAD,
        int(bool(pps.constrained_intra_pred_flag)),
        p(a(st.slice_id, np.int32)), p(a(st.mb_type, np.int32)),
        p(a(st.is_intra, np.uint8)), p(a(st.skip_flag, np.uint8)),
        p(a(st.transform8x8, np.uint8)), p(a(st.qp, np.int32)),
        p(a(st.qpc, np.int32)), p(a(st.i16mode, np.int32)),
        p(a(st.c_ipred_mode, np.int32)), p(a(st.b8mode, np.int32)),
        p(a(st.b8pdir, np.int32)), p(a(st.ipredmode, np.int8)),
        p(a(st.mvd, np.int32)),
        p(ref_idx), p(mv), p(rpid),
        p(a(st.luma_levels, np.int32)), p(a(st.luma8_levels, np.int32)),
        p(a(st.luma_dc, np.int32)), p(a(st.chroma_dc, np.int32)),
        p(a(st.chroma_levels, np.int32)),
        p(Yp), p(Up), p(Vp),
        NS, p(s_type), p(s_spatial), p(s_d8x8), p(s_nref),
        p(s_refids), p(s_reflt), p(s_curpoc), p(s_colpoc),
        p(s_has_col), p(col_moving), p(col_ref0), p(col_ref1),
        p(col_id0), p(col_id1), p(col_mv0), p(col_mv1),
        p(wp_mode), p(wp_ly), p(wp_lc), p(cadj),
        p(wy), p(oyt), p(wct), p(oct_),
        p(wimp), refY, refU, refV, p(ws4), p(ws8), has_ws,
    )
    if fused:
        cbp_blk = a(np.asarray(st.cbp_blk, np.int64), np.int64)
        rc = lib.recon_and_deblock(
            *args, p(cbp_blk), p(a(st.lf_disable, np.int32)),
            p(a(st.lf_alpha, np.int32)), p(a(st.lf_beta, np.int32)),
            int(sps.chroma_format_idc))
    else:
        rc = lib.recon_picture(*args)
    if rc != 0:
        return False
    # write back the arrays that used staging copies
    for src, dst in ((mv, st.mv), (ref_idx, st.ref_idx),
                     (rpid, st.ref_pic_id), (Yp, planes.Y),
                     (Up, planes.U), (Vp, planes.V)):
        if src is not dst:
            np.copyto(dst, src)
    return 2 if fused else True


def cabac_encode_run(kinds: bytes, ctx_idx, bins: bytes, states: bytearray,
                     mps: bytearray):
    """Run the serial CABAC automaton over a recorded bin stream.

    Returns the payload bytes (byte-aligned; includes the flush emitted by
    the final terminate(1)).  Returns None if the native lib is missing."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    n = len(bins)
    idx_arr = np.ascontiguousarray(ctx_idx, dtype=np.int32)
    out = ctypes.create_string_buffer(2 * n // 8 + 4096)
    st_buf = ctypes.create_string_buffer(bytes(states), len(states))
    mps_buf = ctypes.create_string_buffer(bytes(mps), len(mps))
    nbits = lib.cabac_encode_run(
        kinds,
        idx_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bins,
        n,
        ctypes.cast(st_buf, ctypes.c_char_p),
        ctypes.cast(mps_buf, ctypes.c_char_p),
        ctypes.cast(out, ctypes.c_char_p),
        len(out.raw) * 8,
    )
    if nbits % 8:
        raise RuntimeError("CABAC payload must end byte-aligned")
    states[:] = st_buf.raw[: len(states)]
    mps[:] = mps_buf.raw[: len(mps)]
    return out.raw[: nbits // 8]
