"""The yardstick's operation and byte counts against cases worked by hand."""

import pytest
import torch

from benchmark.counts import HBM_BYTES_S, PEAK_FLOPS, bound_s, flop_seconds
from benchmark.counts import sparse


def rows(*coords):
    return torch.tensor(coords, dtype=torch.int64)


def test_pairs_of_a_3x3x3_conv_on_three_voxels_in_a_line():
    # each voxel sees itself and its neighbours along x: 2 + 3 + 2
    r = rows((0, 0, 0, 0), (0, 1, 0, 0), (0, 2, 0, 0))
    assert sparse.neighbour_pairs(r, 3) == 7
    # a diagonal neighbour is inside the 3x3x3 window, one two steps away is not
    r = rows((0, 0, 0, 0), (0, 1, 1, 1), (0, 3, 0, 0))
    assert sparse.neighbour_pairs(r, 3) == 2 + 2 + 1
    assert sparse.neighbour_pairs(r, 5) == 2 + 3 + 2  # the k5 stem reaches it
    # another scene's voxel is no neighbour
    assert sparse.neighbour_pairs(rows((0, 0, 0, 0), (1, 0, 0, 0)), 3) == 2


def test_duplicate_rows_each_read_the_voxel_once():
    # Mix3D: two rows on one voxel; each row reads that voxel and x + 1
    r = rows((0, 4, 4, 4), (0, 4, 4, 4), (0, 5, 4, 4))
    assert sparse.neighbour_pairs(r, 3) == 2 + 2 + 2


def test_levels_halve_the_voxels():
    lv = sparse.levels(rows((0, 0, 0, 0), (0, 1, 1, 1), (0, 2, 0, 0), (1, 0, 0, 0)), 3)
    assert [len(x) for x in lv] == [4, 3, 2]
    assert lv[1].tolist() == [[0, 0, 0, 0], [0, 1, 0, 0], [1, 0, 0, 0]]


def test_spunet_convs_of_the_published_widths():
    convs = sparse.spunet_convs(dict(in_channels=9, num_classes=20,
                                     channels=(32, 64, 128, 256, 256, 128, 96, 96),
                                     layers=(2, 3, 4, 6, 2, 2, 2, 2)))
    kinds = [c.kind for c in convs]
    assert kinds.count("subm") == 1 + 2 * (2 + 3 + 4 + 6) + 2 * 8
    assert kinds.count("down") == kinds.count("up") == 4
    # the four decoder shortcuts (skip concatenated) and the head
    dense = [(c.level, c.cin, c.cout) for c in convs if c.kind == "dense"]
    assert dense == [(3, 384, 256), (2, 192, 128), (1, 128, 96), (0, 128, 96), (0, 96, 20)]
    assert convs[0] == sparse.Conv("subm", 0, 5, 9, 32, dx=False)


def test_flops_of_one_dense_conv_and_one_mlp():
    st = sparse.LevelStats(rows=[10, 4], pairs3=[30, 12], pairs5=50)
    mlp = [sparse.Conv("dense", 0, 1, 4, 5)]  # a per-row (4 -> 5) matmul
    assert sparse.forward_flops(mlp, st) == 2 * 10 * 4 * 5
    assert sparse.train_flops(mlp, st) == 3 * 2 * 10 * 4 * 5
    conv = [sparse.Conv("subm", 1, 3, 8, 16), sparse.Conv("subm", 0, 5, 9, 32, dx=False)]
    assert sparse.forward_flops(conv, st) == 2 * 12 * 8 * 16 + 2 * 50 * 9 * 32
    assert sparse.train_flops(conv, st) == 3 * 2 * 12 * 8 * 16 + 2 * 2 * 50 * 9 * 32
    down_up = [sparse.Conv("down", 0, 2, 8, 16), sparse.Conv("up", 0, 2, 16, 8)]
    assert sparse.forward_flops(down_up, st) == 2 * (2 * 10 * 8 * 16)


def test_bound_takes_the_larger_of_bytes_and_flops():
    assert bound_s(3.35e12, 1.0, "float32") == pytest.approx(1.0)
    assert bound_s(1.0, 989e12, torch.bfloat16) == pytest.approx(1.0)
    assert flop_seconds(495e12, "float32") == pytest.approx(3.0)
    assert PEAK_FLOPS["float32"] == pytest.approx(165e12)


def test_a_band_call_bound_by_hand():
    n, pairs, c = 1000, 5000, 32
    moved = 4 * (n * c + 27 * c * c + n * c) + 4 * pairs
    flops = 2 * pairs * c * c
    got = sparse.subm_call_bound(n, pairs, c, c, 27, False, "float32")
    assert got == pytest.approx(max(moved / HBM_BYTES_S, flops / PEAK_FLOPS["float32"]))
    moved_bwd = 4 * (n * c + n * c + 27 * c * c + n * c + 27 * c * c) + 4 * pairs
    got = sparse.subm_call_bound(n, pairs, c, c, 27, True, "float32")
    assert got == pytest.approx(max(moved_bwd / HBM_BYTES_S,
                                    2 * flops / PEAK_FLOPS["float32"]))
