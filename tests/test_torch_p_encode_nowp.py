"""Port IPPP CABAC encode vs the JAX package without weighted prediction
(the same path minus the affine weighting): byte-identical stream at QP
28, equal recon and reference entries, and every P picture's
``rd_p_pipeline`` outputs from the reference's DPB state at QP 0, 28 and
51.  Helpers and the WP cases: test_torch_p_encode.py."""

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
