"""State carried into the port from the reference package.

A codec has no weights: what one encoder hands the next picture is its
reference entries (the luma bank and padded chroma of each reference
picture), and what the port shares with the reference package is its
constant tables.  These helpers take reference entries made by the JAX
package (as numpy arrays) into the port's tensors, and list the tables the
port keeps its own copies of, so a test can hold them equal.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .encoder.rd import PAD


def ref_entry_from_numpy(bank, cpad, device=None):
    """One reference entry as made by the JAX package (bank (4, Hp, Wp),
    cpad (2, Hcp, Wcp), numpy) -> the port's int32 tensors on `device`."""
    bank = np.asarray(bank)
    cpad = np.asarray(cpad)
    if bank.ndim != 3 or bank.shape[0] != 4 or cpad.ndim != 3 \
            or cpad.shape[0] != 2:
        raise ValueError(f"bank {bank.shape} / cpad {cpad.shape}: expected "
                         "(4, Hp, Wp) and (2, Hcp, Wcp)")
    Hp, Wp = bank.shape[1:]
    if cpad.shape[1:] != ((Hp - 2 * PAD) // 2 + 2 * PAD,
                          (Wp - 2 * PAD) // 2 + 2 * PAD):
        raise ValueError(f"cpad {cpad.shape} does not match bank {bank.shape}")
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    return t(bank), t(cpad)


def encoder_refs_from_numpy(enc, refs, src=None,
                            anchor_ref_pocs=None) -> None:
    """Fill ``enc._rd_refs`` from JAX-made entries, newest first:
    refs = [(poc, bank, cpad, (intra, ref, mvx, mvy)), ...] with numpy
    arrays; the colocated tuple is (4H, 4W) bool, int32, int32, int32 (a
    stored B picture's ref holds its list-0 indices and the sentinel
    len(list 0) for blocks that use list 1 only).  ``src`` = (src_dc,
    src_sd, src_ds), a JAX encoder's per-POC source statistics (its
    ``_src_*`` dicts), which the explicit WP estimate of the next P
    picture reads; ``anchor_ref_pocs``, its ``_anchor_ref_pocs`` (per
    reference POC the POCs its colocated ref indices name), which a B
    picture's temporal direct reads; both replace the encoder's."""
    if src is not None:
        dc, sd, ds = src
        enc._src_dc = {int(k): float(v) for k, v in dc.items()}
        enc._src_sd = {int(k): float(v) for k, v in sd.items()}
        enc._src_ds = {int(k): np.asarray(v, np.float64)
                       for k, v in ds.items()}
    if anchor_ref_pocs is not None:
        enc._anchor_ref_pocs = {int(k): [int(p) for p in v]
                                for k, v in anchor_ref_pocs.items()}
    dev = enc.device
    out = []
    for poc, bank, cpad, col in refs[: enc.sps.num_ref_frames]:
        b, c = ref_entry_from_numpy(bank, cpad, dev)
        intra, ref, mvx, mvy = (np.asarray(a) for a in col)
        out.append((int(poc), b, c, (
            torch.tensor(intra.astype(bool), device=dev),
            *(torch.tensor(a.astype(np.int32), device=dev)
              for a in (ref, mvx, mvy)))))
    enc._rd_refs = out


def decode_inter_args_from_numpy(args, device=None):
    """The arguments of one call of the reference's decoder/device.py
    ``_decode_inter`` (banks, cpads, refmap, ..., ils4c: 25 arrays, as
    numpy) -> the port's int32 tensors on `device`, in the order K8
    (``kernels.decode_inter``) and ``decode_inter_plain`` take them."""
    if len(args) != 25:
        raise ValueError(f"{len(args)} arrays, expected the 25 arguments "
                         "of _decode_inter")
    dev = resolve_device(device)
    return tuple(torch.tensor(np.asarray(a, np.int32), device=dev)
                 for a in args)


# module (relative to the package root) -> the constant tables it copies
_TABLES = {
    "ops.quant": ("DEQUANT4", "QUANT4", "DEQUANT8", "QUANT8", "Q_BITS_8"),
    "ops.interp": ("PAD", "PLANE_OFF"),
    "ops.exact": ("QP_SCALE_CR",),
    "ops.deblock": ("ALPHA_TABLE", "BETA_TABLE", "CLIP_TAB"),
    "decoder.mbtables": ("BLK4_TO_XY", "XY_TO_BLK4", "ZZ_SCAN_4x4",
                         "ZZ_SCAN_8x8", "FIELD_SCAN_4x4", "FIELD_SCAN_8x8",
                         "I16_CBP_TAB", "BLK8_TO_XY", "SUB_MB_P",
                         "SUB_MB_B"),
    "decoder.cavlc_mb": ("_CBP_FROM_CODE",),
    "decoder.mv": ("_B8_PARTS",),
    "decoder.device": ("MAXREF", "_ILS4", "_ILS8"),
    "entropy.cavlc.tables": (
        "COEFF_TOKEN_LEN", "COEFF_TOKEN_CODE", "COEFF_TOKEN_CDC_LEN",
        "COEFF_TOKEN_CDC_CODE", "TOTAL_ZEROS_LEN", "TOTAL_ZEROS_CODE",
        "TOTAL_ZEROS_CDC_LEN", "TOTAL_ZEROS_CDC_CODE", "RUN_BEFORE_LEN",
        "RUN_BEFORE_CODE", "NCBP"),
    "entropy.cavlc.enc": ("_INC_VLC",),
    "encoder.syntax_cavlc": ("_CBP_CODE_INTRA", "_CBP_CODE_INTER",
                             "_B_16x8_CODE", "_B_8x16_CODE",
                             "_SUB_MB_B_CODE", "DC_PRED"),
    "entropy.cabac.tables": (
        "INIT_I", "INIT_P", "RANGE_TAB_LPS", "TRANS_IDX_MPS",
        "TRANS_IDX_LPS", "C1ISDC", "MAX_C2", "MAXPOS", "POS2CTX_MAP",
        "POS2CTX_LAST", "TYPE2CTX_ABS", "TYPE2CTX_BCBP", "TYPE2CTX_LAST",
        "TYPE2CTX_MAP", "TYPE2CTX_ONE"),
}


def carried_tables() -> dict:
    """{"<module>.<name>": value} for every constant table the port keeps
    its own copy of; the same name under the reference package's root
    holds the reference's value."""
    import importlib

    out = {}
    for mod, names in _TABLES.items():
        m = importlib.import_module(f"{__package__}.{mod}")
        for name in names:
            out[f"{mod}.{name}"] = getattr(m, name)
    return out
