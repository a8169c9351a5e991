"""Port IPPP encode vs the JAX package without weighted prediction (the
same path minus the affine weighting): CABAC and CAVLC (the Baseline
profile, the reference's default entropy coder) byte-identical streams
at QP 28, equal recon and reference entries, and every P picture's
``rd_p_pipeline`` outputs from the reference's DPB state at QP 0, 28 and
51 (the CAVLC stream: every P picture at QP 28; entropy is no argument of
the device pipeline, so both share its compiled specialization).  The
native CAVLC writer is the one that writes the CAVLC P slices.  Helpers
and the WP cases: test_torch_p_encode.py."""

import pytest

import test_torch_p_encode as base


def test_stream_byte_identical():
    base.check_stream(28, False)


def test_recon_and_refs_equal():
    base.check_recon_and_refs(28, False)


def test_stream_decodes_to_port_recon():
    base.check_decodes(28, False)


@pytest.mark.parametrize("qp", [0, 28, 51])
def test_pipeline_from_jax_state(qp):
    base.check_pipeline_from_jax_state(qp, False)


CAVLC = {"entropy": "cavlc"}


def test_cavlc_stream_byte_identical():
    base.check_stream(28, False, **CAVLC)
    tenc = base.port_encode(28, False, **CAVLC)[0]
    assert tenc.sps.profile_idc == 66
    assert not tenc.pps.entropy_coding_mode_flag


def test_cavlc_recon_and_refs_equal():
    base.check_recon_and_refs(28, False, **CAVLC)


def test_cavlc_stream_decodes_to_port_recon():
    base.check_decodes(28, False, **CAVLC)


def test_cavlc_pipeline_from_jax_state():
    base.check_pipeline_from_jax_state(28, False, every=True, **CAVLC)
