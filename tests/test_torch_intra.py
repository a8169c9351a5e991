"""Port intra path (h264_tpu_torch.encoder.rd) vs the JAX package.

Each intra helper and the whole wavefront commit (`rd_i_pipeline`, all 11
outputs) on seeded numpy inputs, jitted JAX on the CPU vs the port's plain
PyTorch version on the CPU; exact equality.  The CUDA kernel is held
against the same plain version on the card (tests/test_torch_kernels.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_tpu.encoder import rd as JRD
from h264_tpu.ops.exact import chroma_qp
from h264_tpu_torch.encoder import rd as TRD
from h264_tpu_torch.kernels import intra_commit as K1
from h264_tpu_torch.tools.synthseq import synthetic_frames

OUTS = "ry ru rv lev lum_dc i16mode cip levc dcc i4flag ipm".split()


def _t(a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _eq(ours, theirs, what=""):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs), what)


def _lam(qp):
    return int(0.85 * 0.95 * 2.0 ** ((qp - 12) / 3.0) * 65536 + 0.5)


@pytest.fixture(scope="module")
def rng():
    return np.random.RandomState(5)


def _flags(n):
    au = np.arange(n) % 2 == 1
    al = (np.arange(n) // 2) % 2 == 1
    return au, al


def test_i16_pred_all(rng):
    n = 16
    up = rng.randint(0, 256, (n, 16)).astype(np.int32)
    left = rng.randint(0, 256, (n, 16)).astype(np.int32)
    ul = rng.randint(0, 256, n).astype(np.int32)
    orig = rng.randint(0, 256, (n, 16, 16)).astype(np.int32)
    orig[::3] = up[::3, None, :]  # some MBs with a clear vertical winner
    au, al = _flags(n)
    want = jax.jit(JRD._i16_pred_all)(*map(jnp.asarray,
                                           (up, left, ul, au, al, orig)))
    got = TRD._i16_pred_all(_t(up), _t(left), _t(ul), _t(au, torch.bool),
                            _t(al, torch.bool), _t(orig))
    _eq(got[0], want[0], "pred")
    _eq(got[1], want[1], "mode")


@pytest.mark.parametrize("qp", [0, 17, 28, 51])
def test_i16_tq_and_chroma_tq(rng, qp):
    pred = rng.randint(0, 256, (6, 16, 16)).astype(np.int32)
    orig = (pred + rng.randint(-60, 61, pred.shape)).clip(0, 255)
    want = jax.jit(JRD._i16_tq)(jnp.asarray(pred), jnp.asarray(orig),
                                jnp.int32(qp))
    for g, w, name in zip(TRD._i16_tq(_t(pred), _t(orig), qp), want,
                          ("lev", "dc_lev", "rec", "D", "cb")):
        _eq(g, w, name)
    cpred = rng.randint(0, 256, (3, 4, 2, 8, 8)).astype(np.int32)
    corig = (cpred + rng.randint(-90, 91, cpred.shape)).clip(0, 255)
    qpc = chroma_qp(qp, 0)
    want = jax.jit(functools.partial(JRD._chroma_tq, intra=True))(
        jnp.asarray(cpred), jnp.asarray(corig), jnp.int32(qpc))
    for g, w, name in zip(TRD._chroma_tq(_t(cpred), _t(corig), qpc), want,
                          ("lev", "dc", "rec")):
        _eq(g, w, name)


def test_i4_pred9(rng):
    n = 64
    up, ur, left = (rng.randint(0, 256, (n, 4)).astype(np.int32)
                    for _ in range(3))
    X = rng.randint(0, 256, n).astype(np.int32)
    flags = [(np.arange(n) >> k) % 2 == 1 for k in range(4)]
    want = jax.jit(jax.vmap(JRD._i4_pred9))(
        *map(jnp.asarray, (up, ur, left, X, *flags)))
    got = TRD._i4_pred9(_t(up), _t(ur), _t(left), _t(X),
                        *(_t(f, torch.bool) for f in flags))
    _eq(got[0], want[0], "preds")
    _eq(got[1], want[1], "valid")


def test_chroma_pred4(rng):
    n = 16
    up = rng.randint(0, 256, (n, 2, 8)).astype(np.int32)
    left = rng.randint(0, 256, (n, 2, 8)).astype(np.int32)
    ul = rng.randint(0, 256, (n, 2)).astype(np.int32)
    au, al = _flags(n)
    want = jax.jit(jax.vmap(JRD._chroma_pred4))(
        *map(jnp.asarray, (up, left, ul, au, al)))
    got = TRD._chroma_pred4(_t(up), _t(left), _t(ul), _t(au, torch.bool),
                            _t(al, torch.bool))
    _eq(got, want)


@pytest.mark.parametrize("n_my,n_mx", [(1, 1), (3, 1), (1, 5), (3, 4),
                                       (9, 11), (18, 22)])
def test_wavefront_lanes(n_my, n_mx):
    """Each step's lanes are exactly the MBs with 2r + c == t, in row
    order, and every MB is committed once, after its three neighbours."""
    s = TRD.IntraScan(n_my, n_mx, 28, 28, 0, *([None] * 17))
    when = {}
    for t in range(s.steps):
        r0, n = s.lanes(t)
        want = [r for r in range(n_my) if 0 <= t - 2 * r < n_mx]
        assert list(range(r0, r0 + n)) == want
        for r in want:
            when[(r, t - 2 * r)] = t
    assert len(when) == n_my * n_mx
    for (r, c), t in when.items():
        for nb in ((r, c - 1), (r - 1, c), (r - 1, c + 1)):
            if nb in when:
                assert when[nb] < t


SHAPES = [(64, 48), (176, 144)]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def pipeline_case(request):
    """One shape: seeded frame + the JAX outputs at QP 0, 28, 51 (one
    compile per shape: qp, qp_c and lambda are traced)."""
    W, H = request.param
    Y, U, V = synthetic_frames(1, W, H, seed=W)[0]
    want = {}
    for qp in (0, 28, 51):
        qpc = chroma_qp(qp, 0)
        want[qp] = [np.asarray(x) for x in JRD.rd_i_pipeline(
            jnp.asarray(Y), jnp.asarray(U), jnp.asarray(V), qp=jnp.int32(qp),
            qp_c=jnp.int32(qpc), lam=jnp.int32(_lam(qp)), H=H, W=W)]
    return (W, H, Y, U, V), want


@pytest.mark.parametrize("qp", [0, 28, 51])
def test_rd_i_pipeline(pipeline_case, qp):
    (W, H, Y, U, V), want = pipeline_case
    got = TRD.rd_i_pipeline(Y, U, V, qp, chroma_qp(qp, 0), _lam(qp), H, W,
                            device="cpu")
    for name, g, w in zip(OUTS, got, want[qp]):
        _eq(g, w, name)


def test_commit_step_dispatch_on_cpu():
    """On CPU tensors the K1 wrapper runs the plain scan and launches
    nothing."""
    Y, U, V = synthetic_frames(1, 48, 32, seed=1)[0]
    before = K1.intra_commit_scan.launches
    a = TRD.rd_i_pipeline(Y, U, V, 28, 28, _lam(28), 32, 48, device="cpu")
    b = TRD.rd_i_pipeline(Y, U, V, 28, 28, _lam(28), 32, 48, device="cpu",
                          impl=K1.intra_commit_scan_plain)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert K1.intra_commit_scan.launches == before


def _pb_scan_inputs(rng):
    """The P/B form of the scan at 64x48: seeded inter results and about
    half the MBs intra."""
    W, H = 64, 48
    n_mb = (H // 16) * (W // 16)
    Y, U, V = (x.astype(np.int32)
               for x in synthetic_frames(1, W, H, seed=9)[0])
    w_rec = rng.randint(0, 256, (n_mb, 16, 16)).astype(np.int32)
    recc = rng.randint(0, 256, (n_mb, 2, 8, 8)).astype(np.int32)
    is_intra = rng.rand(n_mb) < 0.5
    w_lev = rng.randint(-3, 4, (n_mb, 4, 4, 4, 4)).astype(np.int32)
    levc = rng.randint(-2, 3, (n_mb, 2, 2, 2, 4, 4)).astype(np.int32)
    dcc = rng.randint(-5, 6, (n_mb, 2, 2, 2)).astype(np.int32)
    return W, H, (Y, U, V, w_rec, recc, is_intra, w_lev, levc, dcc)


def _torch_args(args):
    return tuple(_t(a, torch.bool if a.dtype == bool else torch.int32)
                 for a in args)


def test_commit_scan_inter_copy_through(rng):
    """The P/B form of the scan: MBs with is_intra False copy their inter
    recon and levels through while intra MBs re-decide around them."""
    qp = 30
    W, H, args = _pb_scan_inputs(rng)
    fn = jax.jit(functools.partial(JRD._intra_commit_scan, H=H, W=W, qp=qp,
                                   qp_c=chroma_qp(qp, 0), lam=_lam(qp)))
    want = fn(*map(jnp.asarray, args))
    got = TRD._intra_commit_scan(
        *_torch_args(args), H=H, W=W, qp=qp, qp_c=chroma_qp(qp, 0),
        lam=_lam(qp))
    for name, g, w in zip(OUTS, got, want):
        _eq(g, w, name)


def _topological_order(n_my, n_mx, seed):
    """The MBs in raster order (seed None), or in a seeded random order in
    which every MB comes after its left, up-left, up and up-right
    neighbours: at each pick, any MB whose four neighbours are done."""
    if seed is None:
        return [(r, c) for r in range(n_my) for c in range(n_mx)]
    rnd = np.random.RandomState(seed)
    done, order = set(), []
    while len(order) < n_my * n_mx:
        ready = [(r, c) for r in range(n_my) for c in range(n_mx)
                 if (r, c) not in done and all(
                     nb in done or not (0 <= nb[0] < n_my
                                        and 0 <= nb[1] < n_mx)
                     for nb in ((r, c - 1), (r - 1, c - 1), (r - 1, c),
                                (r - 1, c + 1)))]
        rc = ready[rnd.randint(len(ready))]
        done.add(rc)
        order.append(rc)
    return order


@pytest.fixture(scope="module")
def commit_order_case():
    """The P/B scan inputs at 64x48 with the reference's outputs and the
    anti-diagonal plain scan's."""
    qp = 30
    W, H, args = _pb_scan_inputs(np.random.RandomState(11))
    kw = dict(H=H, W=W, qp=qp, qp_c=chroma_qp(qp, 0), lam=_lam(qp))
    want = jax.jit(functools.partial(JRD._intra_commit_scan, **kw))(
        *map(jnp.asarray, args))
    plain = TRD._intra_commit_scan(*_torch_args(args), **kw)
    return args, kw, [np.asarray(x) for x in want], plain


@pytest.mark.parametrize("seed", [None, 0, 1, 2],
                         ids=["raster", "random0", "random1", "random2"])
def test_commit_order_does_not_matter(commit_order_case, seed):
    """Committing the MBs one at a time in any order in which each comes
    after its left, up-left, up and up-right neighbours gives the
    anti-diagonal scan's outputs and the reference's, exactly: the
    premise of the CUDA kernel's row progress counters."""
    args, kw, want, plain = commit_order_case
    n_my, n_mx = kw["H"] // 16, kw["W"] // 16
    order = _topological_order(n_my, n_mx, seed)
    if seed is not None:
        assert order != _topological_order(n_my, n_mx, None)

    def by_mb(s):
        for r, c in order:
            TRD._intra_mb(s, r, c)

    got = TRD._intra_commit_scan(*_torch_args(args), **kw, impl=by_mb)
    for name, g, p, w in zip(OUTS, got, plain, want):
        assert torch.equal(g, p), name
        _eq(g, w, name)


def _cu_table(name):
    """The int rows of the __constant__ table `name` of
    csrc/intra_commit.cu."""
    import pathlib
    import re

    src = (pathlib.Path(TRD.__file__).parent.parent / "csrc"
           / "intra_commit.cu").read_text()
    body = re.search(r"__constant__ int " + name + r"\[[^=]*= \{(.*?)\};",
                     src, re.S).group(1)
    rows = re.findall(r"\{([^{}]*)\}", body) or [body]
    return [[int(v, 0) for v in re.findall(r"-?0x[0-9a-f]+|-?\d+", row)]
            for row in rows]


def test_k1_tap_table_matches_i4_pred9(rng):
    """The kernel's per-sample prediction taps give `_i4_pred9` for every
    mode on random neighbours (DC, kind 3: the sums of the row's four
    lanes' up and left taps)."""
    taps = _cu_table("kTap")
    assert [len(t) for t in taps] == [16] * 9
    n = 200
    up, ur, left = (rng.randint(0, 256, (n, 4)) for _ in range(3))
    X = rng.randint(0, 256, (n, 1))
    T = torch.ones(n, dtype=torch.bool)
    want, _ = TRD._i4_pred9(*(_t(a) for a in (up, ur, left, X[:, 0])),
                            T, T, T, T)
    p = np.concatenate([up, ur, left, X], 1)
    for m in range(9):
        for k, tap in enumerate(taps[m]):
            a, b, c = (p[:, (tap >> s) & 15] for s in (0, 4, 8))
            kind = tap >> 12
            row = taps[m][k & 12: (k & 12) + 4]
            su, sl = (sum(p[:, (t >> s) & 15] for t in row) for s in (0, 4))
            got = (a if kind == 0 else (a + b + 1) >> 1 if kind == 1
                   else (a + 2 * b + c + 2) >> 2 if kind == 2
                   else (su + sl + 4) >> 3)
            np.testing.assert_array_equal(
                got, want[:, m, k >> 2, k & 3].numpy(), f"mode {m} k {k}")


def test_k1_i4_wavefront_steps():
    """The kernel's I4 steps: each 4x4 block once, at step 2 by + bx, after
    its left, up and up-left blocks and, where z-order has it
    (`_I4_AUR_INT`), its up-right one; mode prediction reads only left
    and up."""
    steps = _cu_table("kStep")
    when = {}
    for t, pair in enumerate(steps):
        for blk in pair:
            if blk >= 0:
                bx, by = TRD._BLK4_XY[blk]
                assert 2 * by + bx == t
                when[(bx, by)] = t
    assert len(when) == 16
    for blk, (bx, by) in enumerate(TRD._BLK4_XY):
        deps = [(bx - 1, by), (bx, by - 1), (bx - 1, by - 1)]
        if TRD._I4_AUR_INT[blk]:
            deps.append((bx + 1, by - 1))
        for d in deps:
            if d in when:
                assert when[d] < when[(bx, by)]
    assert _cu_table("kAurInt") == [[int(v) for v in TRD._I4_AUR_INT]]
