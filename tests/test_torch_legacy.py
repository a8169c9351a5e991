"""The legacy P16x16 path (``rd=False``) of the port against the JAX
package, on the CPU, exactly: every plain function of
h264_tpu_torch/encoder/fast.py against its h264_tpu.encoder.fast
counterpart (the integer search, the quarter-pel refinement, luma and
chroma coding, ``_p_frame_core``, ``p_frame_device``, ``p_frame_pipeline``,
the strengths, the filter, the half-pel planes, ``ref_resources``,
``stack_outputs`` as the encoder's ``fetch_group``) on seeded pictures and on the built inputs of
tools/p16_cases.py (0/255 and flat planes, motion to +-R at every edge)
at QP 0, 28 and 51; legacy encodes (CAVLC and CABAC IPPP, IDR period,
pipeline depths 1 and 8, B pictures on the host path, fast=False) byte-
identical with equal recons and reference state; the RD path's stream
smaller than the legacy one; the two configurations the reference fails
on failing in the port at the same picture.

Shapes: 176x144, search range 8.  The reference's p_frame_pipeline is
compiled for QP 0, 28 and 51 (its QP-28 specialization is the one the
encodes use); the search and the pieces after it are read from an eager
run of the reference's ``_p_frame_core`` (its integer search through a
jax.numpy whose ``argmin`` records its result).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import fast as JF
from h264_tpu.encoder.encoder import EncoderConfig as JaxConfig
from h264_tpu.encoder.encoder import H264Encoder as JaxEncoder
from h264_tpu_torch.decoder import mbtables as M
from h264_tpu_torch.decoder.decoder import decode_annexb
from h264_tpu_torch.encoder import fast as TF
from h264_tpu_torch.encoder.encoder import (EncoderConfig, H264Encoder,
                                            fetch_group)
from h264_tpu_torch.tools.p16_cases import built_case, reached_sides
from h264_tpu_torch.tools.synthseq import moving_frames

W, H, R = 176, 144, 8
QPS = (0, 28, 51)
# (input, QP): seeded pictures at every QP, the built ones where they bite
CASES = [("seeded", q) for q in QPS] + [
    ("0_255", 28), ("255_0", 51), ("flat", 0), ("flat", 28), ("edges", 0),
    ("edges", 28), ("edges", 51)]
IDS = [f"{c}-qp{q}" for c, q in CASES]


def _np(x):
    return np.asarray(x)


def _eq(a, b, what=""):
    a, b = _np(a), b.numpy() if isinstance(b, torch.Tensor) else _np(b)
    assert a.size == b.size, what
    np.testing.assert_array_equal(a.reshape(b.shape), b, err_msg=what)


@functools.lru_cache(maxsize=None)
def lam(qp: int) -> int:
    """The legacy encoder's lambda_me at `qp` (IPPP)."""
    return H264Encoder(EncoderConfig(width=W, height=H, qp=qp, fast=True,
                                     rd=False), device="cpu").lambda_mode_fx


@functools.lru_cache(maxsize=None)
def frames():
    return moving_frames(5, W, H, seed=31)


@functools.lru_cache(maxsize=None)
def inputs(case: str):
    """(cur (Y, U, V), reference state (Ypad, b, h, j, Upad, Vpad)) int32
    numpy: the second seeded picture against the first's state as the
    reference package builds it, or a built case."""
    if case != "seeded":
        cur, ref = built_case(case, H, W, R, seed=7)
        return cur, tuple(np.ascontiguousarray(x) for x in ref)

    class Planes:
        pass

    pl = Planes()
    pl.Y, pl.U, pl.V = (np.asarray(p, np.int32) for p in frames()[0])
    ref = tuple(_np(x) for x in JF.ref_resources(pl))
    return tuple(np.asarray(p, np.int32) for p in frames()[1]), ref


def _t(arrs):
    return tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in arrs)


class _Argmins:
    """jax.numpy, with the concrete results of ``argmin`` over axis 0 (the
    reference's integer search, fast.py:156) recorded."""

    def __init__(self):
        self.got = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmin(self, a, axis=None, **kw):
        r = jnp.argmin(a, axis=axis, **kw)
        if axis == 0 and not isinstance(r, jax.core.Tracer):
            self.got.append(_np(r))
        return r


@functools.lru_cache(maxsize=None)
def ref_core(case: str, qp: int):
    """The reference's ``_p_frame_core`` outputs (eager) and its integer
    vectors (int_mvx, int_mvy)."""
    cur, ref = inputs(case)
    rec = _Argmins()
    JF.jnp = rec
    try:
        out = JF._p_frame_core(*map(jnp.asarray, cur), *map(jnp.asarray, ref),
                               H, W, R, qp, qp, lam(qp))
    finally:
        JF.jnp = jnp
    (best,) = rec.got
    D = 2 * R + 1
    return tuple(_np(x) for x in out), best % D - R, best // D - R


def test_mv_bits():
    d = jnp.arange(-4000, 4001, dtype=jnp.int32)
    _eq(JF._mv_bits_arr(d), TF.mv_bits(torch.arange(-4000, 4001,
                                                    dtype=torch.int32)))


@pytest.mark.parametrize("case,qp", CASES, ids=IDS)
def test_search(case, qp):
    cur, ref = inputs(case)
    out, imx, imy = ref_core(case, qp)
    mx, my, grid0 = TF.search_plain(*_t((cur[0], ref[0])), R, lam(qp))
    _eq(imx, mx, "int_mvx")
    _eq(imy, my, "int_mvy")
    _eq(out[10], grid0, "grids[R, R]")
    if case == "edges":  # motion to +-R toward every picture edge
        assert min(reached_sides(mx, my, R).values()) > 0
    if case == "0_255":  # every term at its largest
        assert int(grid0.min()) == 256 * 255 ** 2


@pytest.mark.parametrize("case,qp", CASES, ids=IDS)
def test_refine(case, qp):
    cur, ref = inputs(case)
    out, imx, imy = ref_core(case, qp)
    mvx, mvy, _ = TF.refine_plain(*_t((cur[0], *ref[:4], imx, imy)),
                                  lam(qp))
    _eq(out[0], mvx, "mvx")
    _eq(out[1], mvy, "mvy")


@pytest.mark.parametrize("case,qp", CASES, ids=IDS)
def test_luma_tq(case, qp):
    cur, ref = inputs(case)
    out, imx, imy = ref_core(case, qp)
    _, _, pred = TF.refine_plain(*_t((cur[0], *ref[:4], imx, imy)), lam(qp))
    lev, rec = TF.luma_tq_plain(torch.as_tensor(cur[0]), pred, qp)
    _eq(out[2], lev, "lev")
    _eq(out[3], rec, "rec_y")


@pytest.mark.parametrize("case,qp", CASES, ids=IDS)
def test_chroma(case, qp):
    cur, ref = inputs(case)
    out, _, _ = ref_core(case, qp)
    for i, (c, pad) in enumerate(((cur[1], ref[4]), (cur[2], ref[5]))):
        got = TF.chroma_plain(*_t((c, pad, out[0], out[1])), qp)
        for k, name in enumerate(("lev", "dc", "rec")):
            _eq(out[4 + 3 * i + k], got[k], f"{'uv'[i]} {name}")


@pytest.mark.parametrize("case,qp", CASES, ids=IDS)
def test_p_frame_core(case, qp):
    """The whole core, through the kernel wrappers (their plain versions
    on CPU tensors) and through the plain versions named."""
    cur, ref = inputs(case)
    out, _, _ = ref_core(case, qp)
    for k in (None, TF.PLAIN):
        got = TF.p_frame_core(*_t(cur), *_t(ref), H, W, R, qp, qp, lam(qp),
                              k=k)
        assert len(got) == len(out) == 11
        for i, (a, b) in enumerate(zip(out, got)):
            _eq(a, b, f"output {i}")
            assert b.dtype == torch.int32


_jit_device = jax.jit(JF.p_frame_device, static_argnames=(
    "H", "W", "R", "qp", "qp_c", "lambda_me"))


@pytest.mark.parametrize("case,qp", [("seeded", q) for q in QPS]
                         + [("edges", 28)],
                         ids=[f"seeded-qp{q}" for q in QPS] + ["edges-qp28"])
def test_p_frame_device(case, qp):
    cur, ref = inputs(case)
    want = _jit_device(*map(jnp.asarray, cur), *map(jnp.asarray, ref), H=H,
                       W=W, R=R, qp=qp, qp_c=qp, lambda_me=lam(qp))
    got = TF.p_frame_device(*_t(cur), *_t(ref), H, W, R, qp, qp, lam(qp))
    for i, (a, b) in enumerate(zip(want, got)):
        _eq(a, b, f"output {i}")


@pytest.mark.parametrize("case,qp", [("seeded", q) for q in QPS] + [
    ("0_255", 28), ("flat", 28), ("edges", 28)],
    ids=[f"seeded-qp{q}" for q in QPS] + ["0_255-qp28", "flat-qp28",
                                          "edges-qp28"])
def test_p_frame_pipeline(case, qp):
    """Host buffer, filtered recon and next reference state, from uint8
    planes (the reference's compiled program; QP 28 is the encodes')."""
    cur, ref = inputs(case)
    cur8 = tuple(c.astype(np.uint8) for c in cur)
    host, recon, nref = JF.p_frame_pipeline(
        *map(jnp.asarray, cur8), *map(jnp.asarray, ref), H=H, W=W, R=R,
        qp=qp, qp_c=qp, lambda_me=lam(qp))
    thost, trecon, tnref = TF.p_frame_pipeline(
        *_t(cur8), *_t(ref), H, W, R, qp, qp, lam(qp))
    assert thost.dtype == torch.int32 and thost.dim() == 1
    _eq(host, thost, "host_out")
    for a, b in zip(recon, trecon):
        _eq(a, b, "recon")
    assert len(nref) == len(tnref) == 6
    for a, b in zip(nref, tnref):
        _eq(a, b, "next reference")


def _built_strengths(seed: int):
    rs = np.random.RandomState(seed)
    n_my, n_mx = H // 16, W // 16
    nz4 = rs.rand(4 * n_my, 4 * n_mx) < 0.3
    # components within +-6 of each other: |difference| on both sides of 4
    mvx, mvy = (rs.randint(-6, 7, (n_my, n_mx)).astype(np.int32) + 40
                for _ in range(2))
    return nz4, mvx, mvy


@functools.lru_cache(maxsize=None)
def recorded_strengths():
    """(nz4, mvx, mvy) of the seeded picture at QP 28, and its recon."""
    out, _, _ = ref_core("seeded", 28)
    nz4 = out[2].reshape(H // 4, W // 4, 16).any(-1)
    return (nz4, out[0].reshape(H // 16, W // 16),
            out[1].reshape(H // 16, W // 16)), (out[3], out[6], out[9])


@pytest.mark.parametrize("which", ["recorded", "built"])
def test_strengths_device_p(which):
    """The reference's legacy strengths against the port's one strengths
    function on the legacy glue's fields: 4x4 levels in raster (4 n_my,
    4 n_mx, 4, 4), the recorded picture's, or for the built one a level 1
    in each block it flags; per-MB mvs."""
    args = recorded_strengths()[0] if which == "recorded" else (
        _built_strengths(3))
    want = JF.strengths_device_p(*map(jnp.asarray, args))
    if which == "recorded":
        coef = ref_core("seeded", 28)[0][2].reshape(H // 4, W // 4, 4, 4)
    else:
        coef = np.zeros((H // 4, W // 4, 4, 4), np.int32)
        coef[..., 0, 0] = args[0]
    got = TF.strengths_device_p(*_t((coef, *args[1:])))
    for a, b in zip(want, got):
        _eq(a, b, "bS")
    assert set(np.unique(_np(want[0]))) <= {0, 1, 2}
    if which == "built":
        assert {1, 2} <= set(np.unique(_np(want[0])))


_jit_deblock = jax.jit(JF.deblock_device_p, static_argnames=("qp", "qp_c"))


@pytest.mark.parametrize("which,qp", [("recorded", 28), ("built", 0),
                                      ("built", 28), ("built", 40),
                                      ("built", 51)],
                         ids=["recorded-qp28", "built-qp0", "built-qp28",
                              "built-qp40", "built-qp51"])
def test_deblock_device_p(which, qp):
    if which == "recorded":
        (nz4, mvx, mvy), rec = recorded_strengths()
    else:
        rs = np.random.RandomState(qp)
        nz4, mvx, mvy = _built_strengths(qp)
        rec = (rs.randint(100, 140, (H, W)),
               *rs.randint(100, 140, (2, H // 2, W // 2)))
    rec = tuple(np.asarray(x, np.int32) for x in rec)
    bs = tuple(_np(x) for x in JF.strengths_device_p(
        *map(jnp.asarray, (nz4, mvx, mvy))))
    want = _jit_deblock(*map(jnp.asarray, rec + bs), qp=qp, qp_c=qp)
    got = TF.deblock_device_p(*_t(rec + bs), qp, qp)
    for a, b in zip(want, got):
        _eq(a, b, "filtered plane")
    if which == "built" and qp >= 28:
        assert any((_np(a) != r).any() for a, r in zip(want, rec))


@pytest.mark.parametrize("content", ["random", "0_255"])
def test_half_planes(content):
    rs = np.random.RandomState(5)
    shape = (H + 2 * TF.PAD, W + 2 * TF.PAD)
    Ypad = (rs.randint(0, 256, shape) if content == "random" else
            (np.indices(shape).sum(0) % 2) * 255).astype(np.int32)
    want = JF.half_planes(jnp.asarray(Ypad))
    got = TF.half_planes(torch.as_tensor(Ypad))
    for a, b in zip(want, got):
        assert tuple(b.shape) == (H + 59, W + 59)
        _eq(a, b, "half-pel plane")


def test_ref_resources():
    _, ref = inputs("seeded")  # the reference's state of the first picture
    got = TF.ref_resources(*(np.asarray(p, np.int32) for p in frames()[0]),
                           device="cpu")
    assert len(got) == 6
    for a, b in zip(ref, got):
        _eq(a, b, "reference state")


def test_stack_outputs():
    """The reference's stack_outputs is the port's fetch_group."""
    rs = np.random.RandomState(2)
    flats = [rs.randint(-300, 300, 1000).astype(np.int32) for _ in range(3)]
    want = _np(JF.stack_outputs([jnp.asarray(f) for f in flats]))
    got = fetch_group([torch.as_tensor(f) for f in flats])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# encodes
# ---------------------------------------------------------------------------

ENCODES = {
    "cavlc-depth8": dict(entropy="cavlc"),
    "cabac-depth1": dict(entropy="cabac", pipeline_depth=1),
    "cabac-idr2": dict(entropy="cabac", idr_period=2),
    "b1-host": dict(entropy="cabac", b_frames=1),
    "fast_false": dict(fast=False),
}


@functools.lru_cache(maxsize=None)
def encoded(name: str):
    kw = dict(width=W, height=H, qp=28, search_range=R, fast=True, rd=False)
    kw.update(ENCODES[name])
    jenc = JaxEncoder(JaxConfig(**kw))
    jstream = jenc.encode_sequence(frames())
    tenc = H264Encoder(EncoderConfig(**kw), device="cpu")
    tenc.picture_log = []
    tstream = tenc.encode_sequence(frames())
    return jenc, jstream, tenc, tstream


@pytest.mark.parametrize("name", list(ENCODES))
def test_encode_byte_identical(name):
    jenc, jstream, tenc, tstream = encoded(name)
    assert tstream == jstream
    assert len(tenc.all_recons) == len(jenc.all_recons) == len(frames())
    for (pa, a), (pb, b) in zip(jenc.all_recons, tenc.all_recons):
        assert pa == pb
        for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)):
            np.testing.assert_array_equal(_np(x), _np(y))
    kinds = "".join(k for k, _, _ in tenc.picture_log)
    if name in ("cavlc-depth8", "cabac-depth1", "cabac-idr2"):
        assert kinds == ("IPIPI" if name == "cabac-idr2" else "IPPPP")
        # the legacy P pictures' recons stay on the card until read
        assert type(tenc.all_recons[1][1]).__name__ == "_DevicePlanes"


@pytest.mark.parametrize("name", list(ENCODES))
def test_encode_reference_state(name):
    """The next-reference state each package keeps: the legacy device
    state (Ypad, b, h, j, Upad, Vpad), or the host path's padded planes."""
    jenc, _, tenc, _ = encoded(name)
    legacy = name not in ("b1-host", "fast_false")
    assert (tenc._dev_ref is not None) == legacy
    if legacy:
        for a, b in zip(jenc._dev_ref, tenc._dev_ref):
            _eq(a, b, "device reference state")
    assert len(jenc.recon_pics) == len(tenc.recon_pics)
    for ea, eb in zip(jenc.recon_pics, tenc.recon_pics):
        assert ea[0] == eb[0] and len(ea[3]) == len(eb[3])
        for a, b in zip(ea[3], eb[3]):
            _eq(a, b, "reference entry")


@pytest.mark.parametrize("name", list(ENCODES))
def test_encode_decodes_to_recons(name):
    _, _, tenc, tstream = encoded(name)
    pics = sorted(decode_annexb(tstream, device="cpu"), key=lambda p: p.poc)
    recs = sorted(tenc.all_recons, key=lambda e: e[0])
    assert [p.poc for p in pics] == [p for p, _ in recs]
    for pic, (_, rec) in zip(pics, recs):
        assert pic.to_yuv_bytes() == rec.to_yuv_bytes()


def test_rd_stream_smaller_than_legacy():
    """The reference's rate comparison (tests/test_rd_pipeline.py:86) on
    synthetic frames (a pane of moving content sliding over a still
    picture), in the port: the RD path uses partitions and P_Skip and its
    stream is smaller than the legacy P16x16 one."""
    mf = moving_frames(4, W, H, seed=9)
    fr = []
    for i, f in enumerate(mf):
        Y, U, V = (np.array(p) for p in mf[0])
        Y[48:96, 40 + 3 * i: 88 + 3 * i] = f[0][48:96, 40:88]
        fr.append((Y, U, V))
    sizes, states = {}, []
    for rd in (True, False):
        enc = H264Encoder(EncoderConfig(
            width=W, height=H, qp=28, fast=True, rd=rd, num_ref_frames=1,
            search_range=16), device="cpu")
        if rd:
            fill = enc._fill_p_state_rd

            def keep(st, *a, fill=fill):
                fill(st, *a)
                states.append(st)

            enc._fill_p_state_rd = keep
        sizes[rd] = len(enc.encode_sequence(fr))
    types = np.concatenate([st.mb_type for st in states])
    assert np.concatenate([st.skip_flag for st in states]).any()
    assert set(types.tolist()) & {M.P16x8, M.P8x16, M.P8x8}
    assert sizes[True] < sizes[False], sizes


@pytest.mark.parametrize("kw", [{"slice_mode": 1, "slice_argument": 33},
                                {"rc_bitrate": 350000.0}],
                         ids=["slice_mode=1", "rc_bitrate"])
def test_legacy_host_p_fails_in_both(kw):
    """With several slices or rate control the reference codes the P
    pictures of a legacy stream on its host path, which reads the legacy
    reference state (Ypad, b, h, j, Upad, Vpad) as padded chroma planes:
    TypeError at the first P picture (encoder.py:1961).  The port raises
    NotImplementedError there (ROADMAP Queue 3)."""
    base = dict(width=W, height=H, qp=28, search_range=R, fast=True,
                rd=False, **kw)
    fr = frames()[:3]
    done = {}
    for pkg, enc, exc in (
            ("ref", JaxEncoder(JaxConfig(**base)), TypeError),
            ("port", H264Encoder(EncoderConfig(**base), device="cpu"),
             NotImplementedError)):
        n = 0
        with pytest.raises(exc):
            for _ in enc.encode_stream(fr):
                n += 1
        done[pkg] = n
    assert done == {"ref": 1, "port": 1}
