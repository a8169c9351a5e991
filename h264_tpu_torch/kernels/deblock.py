"""K6 wrappers: boundary strengths and the in-loop deblocking filter.

Kernel: ``csrc/deblock.cu`` (replaces the reference's ``encoder/rd.py:1713
strengths_full``, ``:1928 strengths_full_b`` and ``:1800
deblock_device_full``).  Plain versions: ``encoder.strengths``
``strengths_plain`` and ``encoder.rd_p`` ``deblock_plain``.  CPU tensors
run the plain version; CUDA tensors launch the kernel, or raise.

``strengths`` serves every P, B and legacy picture.  It reads the fields
the glue holds, at their own granularity (``encoder/strengths.py``), and
costs its host time more than its kernel's, so the wrapper makes one
combined test of every input's device, dtype, layout and contiguity
(cached by what it sees) and one allocation: BSV and BSH are the two
views of one (2, H4, W4) buffer.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..device import check_launch, check_tensor, kernel_fn, stream_of
from ..encoder import rd_p
from ..encoder import strengths as ST

strengths_plain = ST.strengths_plain
deblock_plain = rd_p.deblock_plain

_I32 = torch.int32
# the C entry's inputs, in its order: the fields, then pocs0
_INPUTS = (*ST.FIELDS, "pocs0")
_DTYPES = {"intra": torch.bool, "use0": torch.bool, "use1": torch.bool}
_REQUIRED = ("coef", "mv0x", "mv0y")
_MAX_POCS = 64  # the kernel's table of list-0 POCs (csrc/deblock.cu)


@functools.lru_cache(maxsize=256)
def _plan(seen: tuple, n_my: int, n_mx: int):
    """The C entry's layout array for inputs that look like `seen` (per
    input None or its (shape, dtype, device, contiguous)): every field's
    six strides, then the POCs' count.  Raises ValueError naming the
    first input the kernel does not take."""
    given = dict(zip(_INPUTS, seen))
    for name in _REQUIRED:
        if given[name] is None:
            raise ValueError(f"strengths: {name} is required")
    dev = given["mv0x"][2]
    ST.check_lists({k: given[k] for k in ST.TWO_LISTS})
    lay = []
    for name, g in given.items():
        if g is None:
            if name != "pocs0":
                lay += [0] * 6
            continue
        shape, dtype, device, contiguous = g
        want = _DTYPES.get(name, _I32)
        if device != dev or dtype != want or not contiguous:
            raise ValueError(f"strengths: {name} must be a contiguous {want} "
                             f"tensor on {dev}, got {dtype} on {device}")
        if name == "pocs0":
            if len(shape) != 1 or not 1 <= shape[0] <= _MAX_POCS:
                raise ValueError(f"strengths: pocs0 must be (NR0,), NR0 <= "
                                 f"{_MAX_POCS}, got {tuple(shape)}")
            continue
        lay += ST.layout(tuple(shape), n_my, n_mx, name)[0]
    pocs = given["pocs0"]
    lay.append(pocs[0][0] if pocs else 0)
    return (ctypes.c_int * len(lay))(*lay)


def _inputs(n_my, n_mx, coef, intra, ref0, mv0x, mv0y, coef8=None, t8=None,
            pocs0=None, use0=None, mv1x=None, mv1y=None, use1=None, poc1=0):
    """The C entry's tensor inputs of a ``strengths`` call, in its order:
    the fields, then pocs0."""
    return (coef, coef8, intra, t8, ref0, mv0x, mv0y, use0, mv1x, mv1y, use1,
            pocs0)


def layout_of(*args):
    """The C entry's layout array for the arguments of a ``strengths``
    call: the combined test of every input, cached by what it sees;
    raises ValueError for what the kernel does not take."""
    try:
        seen = tuple(None if x is None else
                     (x.shape, x.dtype, x.device, x.is_contiguous())
                     for x in _inputs(*args))
    except AttributeError:  # not a tensor
        raise ValueError("strengths: every input must be a tensor or None")
    return _plan(seen, int(args[0]), int(args[1]))


def strengths(n_my, n_mx, coef, intra, ref0, mv0x, mv0y, coef8=None,
              t8=None, pocs0=None, use0=None, mv1x=None, mv1y=None,
              use1=None, poc1=0):
    """(BSV, BSH) int32 (4 n_my, 4 n_mx), the bS of every 4x4 block's left
    and top edge, from the picture's fields at their own granularity
    (``encoder.strengths.strengths_plain`` has the arguments)."""
    args = (n_my, n_mx, coef, intra, ref0, mv0x, mv0y, coef8, t8, pocs0,
            use0, mv1x, mv1y, use1, poc1)
    if mv0x.device.type == "cpu":
        return strengths_plain(*args)
    lay = layout_of(*args)
    ptrs = (ctypes.c_void_p * 12)(*(None if x is None else x.data_ptr()
                                    for x in _inputs(*args)))
    out = torch.empty((2, 4 * n_my, 4 * n_mx), dtype=_I32,
                      device=mv0x.device)
    rc = kernel_fn("deblock", "strengths", "ppiiipp")(
        ctypes.addressof(ptrs), ctypes.addressof(lay), int(poc1), n_my, n_mx,
        out.data_ptr(), stream_of(mv0x))
    check_launch(rc, "strengths")
    strengths.launches += 1
    return out.unbind(0)


def _thresholds(qp: int):
    alpha, beta, clip_row = rd_p._thresholds(qp, "cpu")
    return [alpha, beta, *(int(v) for v in clip_row)]


def deblock(rec_y, rec_u, rec_v, BSV, BSH, qp: int, qp_c: int):
    """Filtered copies (Y, U, V) of the int32 recon planes, in one launch
    of a persistent kernel; the inputs stay as they are."""
    if rec_y.device.type == "cpu":
        return deblock_plain(rec_y, rec_u, rec_v, BSV, BSH, qp, qp_c)
    dev = rec_y.device
    H, W = rec_y.shape
    if H % 16 or W % 16:
        raise ValueError(f"deblock: picture {W}x{H} is not whole MBs")
    for name, x, shape in (("rec_y", rec_y, (H, W)),
                           ("rec_u", rec_u, (H // 2, W // 2)),
                           ("rec_v", rec_v, (H // 2, W // 2)),
                           ("BSV", BSV, (H // 4, W // 4)),
                           ("BSH", BSH, (H // 4, W // 4))):
        check_tensor("deblock", name, x, shape, _I32, dev)
    thr = (ctypes.c_int * 12)(*_thresholds(qp), *_thresholds(qp_c))
    Y, U, V = (torch.empty_like(x) for x in (rec_y, rec_u, rec_v))
    # the blocks' row ticket, then each MB row's filtered columns (the C
    # entry zeroes them)
    sync = torch.empty(H // 16 + 1, dtype=_I32, device=dev)
    rc = kernel_fn("deblock", "deblock", "pppppii" + "ppppp" + "p")(
        rec_y.data_ptr(), rec_u.data_ptr(), rec_v.data_ptr(), BSV.data_ptr(),
        BSH.data_ptr(), H, W, ctypes.addressof(thr), Y.data_ptr(),
        U.data_ptr(), V.data_ptr(), sync.data_ptr(), stream_of(rec_y))
    check_launch(rc, "deblock")
    deblock.launches += 1
    return Y, U, V


strengths.launches = 0
deblock.launches = 0
