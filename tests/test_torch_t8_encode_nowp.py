"""Port IPPP CABAC encode with the FRExt 8x8 transform and without
weighted prediction vs the JAX package, on the CPU, at QP 28:
byte-identical stream, equal recons and reference entries, and every P
picture's ``rd_p_pipeline`` outputs from the reference's DPB state (the
reference's ``use_t8=True, use_wp=False`` specialization, compiled once
for this file).  The WP and IPB cases: test_torch_t8_encode.py."""

import test_torch_p_encode as base
import test_torch_t8_encode as t8base

T8 = {"t8": True}


def test_stream_byte_identical():
    base.check_stream(28, False, **T8)


def test_recon_and_refs_equal():
    base.check_recon_and_refs(28, False, **T8)


def test_stream_decodes_to_port_recon():
    base.check_decodes(28, False, **T8)


def test_pipeline_from_jax_state():
    base.check_pipeline_from_jax_state(28, False, every=True, **T8)


def test_stream_mixes_8x8_and_4x4():
    n_mb = (base.W // 16) * (base.H // 16)
    n8, n4 = t8base.t8_mix(base.port_encode(28, False, **T8)[2], n_mb)
    assert n8 > 0 and n4 > 0
