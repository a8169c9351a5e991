"""Helpers of the host-path encode tests (test_torch_host_*.py): the JAX
package's encoder and the port's (on the CPU) on the same seeded frames,
and the checks every configuration goes through."""

import functools

import numpy as np
import pytest

from h264_tpu.decoder.decoder import decode_annexb as jax_decode_annexb
from h264_tpu.encoder.encoder import EncoderConfig as JaxConfig
from h264_tpu.encoder.encoder import H264Encoder as JaxEncoder
from h264_tpu_torch.bitstream import iter_annexb_nalus
from h264_tpu_torch.decoder.decoder import decode_annexb
from h264_tpu_torch.encoder.encoder import EncoderConfig, H264Encoder
from h264_tpu_torch.syntax.parsets import parse_sps
from h264_tpu_torch.tools.synthseq import moving_frames

W, H = 176, 144
BASE = dict(width=W, height=H, search_range=8)


@functools.lru_cache(maxsize=None)
def frames(n: int, seed: int = 11):
    return moving_frames(n, W, H, seed=seed)


@functools.lru_cache(maxsize=None)
def qmat_scaling_lists():
    """The lists of the in-repo lencod qmat_sps stream's SPS (as
    tests/test_frext_encode.py reads them): (ws4 (6, 4, 4), ws8 (2, 8, 8))
    int32."""
    with open("tests/streams/qmat_sps.264", "rb") as f:
        data = f.read()
    sps = next(parse_sps(n.rbsp) for n in iter_annexb_nalus(data)
               if n.nal_unit_type == 7)
    return (np.array(sps.scaling_lists_4x4, np.int32).reshape(6, 4, 4),
            np.array(sps.scaling_lists_8x8, np.int32).reshape(2, 8, 8))


def encode_pair(kw: dict, n: int):
    """(JAX encoder, its stream, port encoder, its stream) of `n` frames
    under EncoderConfig(**BASE, **kw)."""
    fr = frames(n)
    jenc = JaxEncoder(JaxConfig(**BASE, **kw))
    jstream = jenc.encode_sequence(fr)
    tenc = H264Encoder(EncoderConfig(**BASE, **kw), device="cpu")
    tstream = tenc.encode_sequence(fr)
    return jenc, jstream, tenc, tstream


def assert_streams_equal(pair):
    _, jstream, _, tstream = pair
    assert len(tstream) > 100
    assert tstream == jstream


def assert_recons_equal(pair, n: int):
    jenc, _, tenc, _ = pair
    assert len(tenc.all_recons) == len(jenc.all_recons) == n
    for (jp, a), (tp, b) in zip(jenc.all_recons, tenc.all_recons):
        assert jp == tp
        for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)):
            np.testing.assert_array_equal(y, np.asarray(x))


def _planes_equal(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in ((a.Y, b.Y), (a.U, b.U), (a.V, b.V)))


def reference_fault(enc):
    """Where the reference package's own decoder does not give back the
    pictures of this configuration's streams (ROADMAP Queue 3), which the
    port reproduces bit for bit: "no-change-cycle" for FMO map types 3-5
    (its slice header writer leaves out slice_group_change_cycle, which
    its parser reads, so the slice data is misread); "split" when a
    picture's first slice starts past MB 0 and a later one at MB 0 (its
    decoder starts a new picture at every slice with first_mb_in_slice 0,
    decoder.py `_is_new_picture`, and decodes each such picture as two);
    else None."""
    if enc.pps.num_slice_groups_minus1 > 0 and \
            enc.pps.slice_group_map_type in (3, 4, 5):
        return "no-change-cycle"
    slices = enc._partition_slices()
    if slices[0][0] != 0 and any(s[0] == 0 for s in slices):
        return "split"
    return None


def assert_decodes_to_recons(pair, n: int):
    """The port's decoder (device path, plain versions on the CPU)
    reconstructs every picture as the port's encoder did: each decoded
    picture equals the encoder's recon of its POC (an IDR period repeats
    POCs, so each recon is matched once).  Where the reference's decoder
    fails on its own stream (`reference_fault`), the port's decoder does
    what the reference's does: the same error, or the same pictures."""
    _, _, tenc, tstream = pair
    fault = reference_fault(tenc)
    if fault == "no-change-cycle":
        for decode in (jax_decode_annexb,
                       lambda s: decode_annexb(s, device="cpu")):
            with pytest.raises(ValueError, match="corrupt CAVLC slice"):
                decode(tstream)
        return
    pics = decode_annexb(tstream, device="cpu")
    if fault == "split":
        ref = jax_decode_annexb(tstream)
        assert len(pics) == len(ref) == 2 * n
        assert [p.to_yuv_bytes() for p in pics] == [
            p.to_yuv_bytes() for p in ref]
        return
    assert len(pics) == len(tenc.all_recons) == n
    left = list(tenc.all_recons)
    for pic in pics:
        hit = next((i for i, (poc, rec) in enumerate(left)
                    if poc == pic.poc and _planes_equal(pic.planes, rec)),
                   None)
        assert hit is not None, f"decoded POC {pic.poc} equals no recon"
        left.pop(hit)
