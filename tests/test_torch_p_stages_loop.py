"""Stages 6 (the wavefront intra commit with inter copy-through,
rd.py:1115-1123) and 7 (strengths and deblocking, :1124-1160) of the
port's P pipeline against the JAX package's ``rd_p_pipeline(stage=k)``
checksums (setup and the other stages in test_torch_p_stages.py)."""

import pytest

import test_torch_p_stages as base


@pytest.mark.parametrize("stage", [6, 7])
def test_stage_checksum(stage):
    assert base._port()[stage] == base.jax_checksum(stage)
