"""Stages 4 (candidate decision, rd.py:820-1013) and 5 (winner gather and
inter chroma, :1015-1069) of the port's P pipeline against the JAX
package's ``rd_p_pipeline(stage=k)`` checksums (setup and the other
stages in test_torch_p_stages.py)."""

import pytest

import test_torch_p_stages as base


@pytest.mark.parametrize("stage", [4, 5])
def test_stage_checksum(stage):
    assert base._port()[stage] == base.jax_checksum(stage)
