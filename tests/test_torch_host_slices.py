"""Multi-slice, FMO, data partitioning and redundant slices of the port's
host-path encoder vs the JAX package's, on the CPU: identical Annex-B
bytes and recon planes for 3 seeded 176x144 frames at search range 8
(``slice_mode=1``; FMO map types 0-6 with two slice groups, 3-5 with a
change cycle; CAVLC data partitioning with and without slices; redundant
slices, CAVLC and CABAC; fast=True with slices), every stream decoding
through the port's decoder, partitions and redundant copies all present,
to the encoder's recons."""

import pytest

from h264_tpu_torch.bitstream import iter_annexb_nalus
from torch_host_pairs import (assert_decodes_to_recons, assert_recons_equal,
                              assert_streams_equal, encode_pair)

N = 3
_N_MB = 99  # 176x144
CONFIGS = {
    "slices33": dict(slice_mode=1, slice_argument=33),
    "fmo0": dict(num_slice_groups=2, slice_group_map_type=0,
                 slice_group_run_length=(5, 6)),
    "fmo1": dict(num_slice_groups=2, slice_group_map_type=1),
    "fmo2": dict(num_slice_groups=2, slice_group_map_type=2,
                 slice_group_rects=((12, 58),)),
    **{f"fmo{t}": dict(num_slice_groups=2, slice_group_map_type=t,
                       slice_group_change_direction=t == 4,
                       slice_group_change_rate=7,
                       slice_group_change_cycle=5) for t in (3, 4, 5)},
    "fmo6": dict(num_slice_groups=2, slice_group_map_type=6,
                 slice_group_ids=tuple(i % 3 == 0 for i in range(_N_MB))),
    "dp": dict(partition_mode=1),
    "dp-slices": dict(partition_mode=1, slice_mode=1, slice_argument=33),
    "redundant-cavlc": dict(redundant_pics=True),
    "redundant-cabac": dict(redundant_pics=True, entropy="cabac"),
    "fast-slices": dict(fast=True, rd=True, entropy="cabac", slice_mode=1,
                        slice_argument=33),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    kw = dict(CONFIGS[request.param])
    if "slice_group_ids" in kw:
        kw["slice_group_ids"] = tuple(int(v) for v in kw["slice_group_ids"])
    return request.param, encode_pair(kw, N)


def test_stream_byte_identical(pair):
    assert_streams_equal(pair[1])


def test_recons_equal(pair):
    assert_recons_equal(pair[1], N)


def test_stream_decodes_to_recons(pair):
    assert_decodes_to_recons(pair[1], N)


def test_nal_layout(pair):
    """The NAL types of each configuration: several slices per picture,
    DPA/DPB/DPC partitions on the P pictures, a redundant slice after each
    primary P slice."""
    name, (_, _, tenc, tstream) = pair
    types = [n.nal_unit_type for n in iter_annexb_nalus(tstream)]
    assert types[:2] == [7, 8]
    if name.startswith("dp"):
        assert 2 in types and (3 in types or 4 in types) and 1 not in types
    elif name.startswith("redundant"):
        assert types.count(1) == 2 * (N - 1) and types.count(5) == 1
    else:
        assert types.count(5) >= 2 and tenc._multi_slice
