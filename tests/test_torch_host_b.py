"""The port's host-path B pictures (spatial direct, L0/L1/bi-prediction
and intra from the SAD grids of both lists) vs the JAX package's, on the
CPU: identical Annex-B bytes and recon planes for 5 seeded 176x144 frames
(I P B P B) at search range 8, CAVLC and CABAC, with the 8x8 transform,
and with fast=True and several slices (host P and B pictures after the
first I picture, their references also entering the device DPB); every
stream decodes through the port's decoder to the encoder's recons."""

import numpy as np
import pytest

from torch_host_pairs import (assert_decodes_to_recons, assert_recons_equal,
                              assert_streams_equal, encode_pair)

N = 5
CONFIGS = {
    "b-cavlc": dict(b_frames=1),
    "b-cabac": dict(b_frames=1, entropy="cabac"),
    "b-t8": dict(b_frames=1, entropy="cabac", transform8x8=True),
    "b-fast-slices": dict(b_frames=1, fast=True, rd=True, entropy="cabac",
                          slice_mode=1, slice_argument=33),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return encode_pair(dict(CONFIGS[request.param]), N)


def test_stream_byte_identical(pair):
    assert_streams_equal(pair)


def test_recons_equal(pair):
    assert_recons_equal(pair, N)


def test_stream_decodes_to_recons(pair):
    assert_decodes_to_recons(pair, N)


def test_decode_order_and_slice_types(pair):
    """I P B P B in decode order, POCs 0 4 2 8 6, as the reference."""
    jenc, _, tenc, _ = pair
    assert [p for p, _ in tenc.all_recons] == [0, 4, 2, 8, 6]
    assert [p for p, _ in jenc.all_recons] == [0, 4, 2, 8, 6]


def test_fast_multi_slice_references_enter_the_device_dpb():
    """fast=True with several slices: every reference picture also makes
    its device bank entry (all-intra colocated motion), equal to the
    reference's."""
    jenc, _, tenc, _ = encode_pair(CONFIGS["b-fast-slices"], 3)
    assert len(tenc._rd_refs) == len(jenc._rd_refs) == 2
    for (jp, jb, jc, jcol), (tp, tb, tc, tcol) in zip(jenc._rd_refs,
                                                      tenc._rd_refs):
        assert jp == tp
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        for x, y in zip(tcol, jcol):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert all(e[3] is not None for e in tenc.recon_pics)
