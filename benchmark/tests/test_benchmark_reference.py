"""The plain reference's sparse convs against dense-grid convs, and the
reference against the program at a small size on the CPU."""

import itertools
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import spunet as ref


def scene(n=40, size=6, batches=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    cells = torch.randperm(batches * size ** 3, generator=g)[:n]
    b, rest = cells // size ** 3, cells % size ** 3
    coords = torch.stack([b, rest // size ** 2, rest // size % size, rest % size], 1)
    return coords.to(torch.int64)


def dense(coords, x, size, batches):
    grid = torch.zeros(batches, x.shape[1], size, size, size, dtype=x.dtype)
    grid[coords[:, 0], :, coords[:, 1], coords[:, 2], coords[:, 3]] = x
    return grid


def test_submanifold_conv_equals_a_dense_conv_at_the_active_voxels():
    coords, size = scene(), 6
    g = torch.Generator().manual_seed(1)
    x = torch.randn(len(coords), 3, dtype=torch.float64, generator=g)
    w = torch.randn(3, 3, 3, 3, 4, dtype=torch.float64, generator=g)
    got = ref.conv(x, w, ref.subm_rule(coords, 3), ref.Precision())
    # tap (a, b, c) reads v + (a, b, c) - 1: a cross-correlation with padding 1
    want = F.conv3d(dense(coords, x, size, 2), w.permute(4, 3, 0, 1, 2), padding=1)
    want = want[coords[:, 0], :, coords[:, 1], coords[:, 2], coords[:, 3]]
    torch.testing.assert_close(got, want)


def test_down_and_inverse_conv_equal_dense_stride_2_convs():
    coords, size = scene(n=60, size=8), 8
    g = torch.Generator().manual_seed(2)
    x = torch.randn(len(coords), 3, dtype=torch.float64, generator=g)
    w = torch.randn(2, 2, 2, 3, 5, dtype=torch.float64, generator=g)
    lv = ref.build_levels(coords, 2)
    got = ref.conv(x, w, ref.down_rule(lv[0], len(lv[1].coords)), ref.Precision())
    want = F.conv3d(dense(coords, x, size, 2), w.permute(4, 3, 0, 1, 2), stride=2)
    c = lv[1].coords
    torch.testing.assert_close(got, want[c[:, 0], :, c[:, 1], c[:, 2], c[:, 3]])
    y = torch.randn(len(c), 5, dtype=torch.float64, generator=g)
    wi = torch.randn(2, 2, 2, 5, 3, dtype=torch.float64, generator=g)
    got = ref.conv(y, wi, ref.up_rule(lv[0]), ref.Precision())
    want = F.conv_transpose3d(dense(c, y, size // 2, 2), wi.permute(3, 4, 0, 1, 2), stride=2)
    torch.testing.assert_close(got, want[coords[:, 0], :, coords[:, 1], coords[:, 2],
                                         coords[:, 3]])


def test_conv_backward_is_the_gradient_of_its_forward_with_duplicate_rows():
    coords = torch.cat([scene(n=20, size=4, batches=1), scene(n=20, size=4, batches=1,
                                                              seed=5)])
    rule = ref.subm_rule(coords, 3)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(len(coords), 2, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(27, 2, 3, dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: ref.conv(a, b, rule, ref.Precision()),
                                    (x, w))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -12, -3.0 - 2 ** -20])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, 1.0, -3.0])
    assert torch.equal(ref.tf32_round(x), want)  # ties to even


def test_fragments_hold_the_programs_test_voxelisation(tmp_path):
    """The benchmark's own test pipeline finds every fragment that the
    program's dataset makes of a scene as the recipe gives it, and finds a
    row moved to another voxel and a fragment left out."""
    from ponderv2_tpu_torch.datasets import build_dataset
    from ponderv2_tpu_torch.utils.config import Config

    from benchmark.harness import core, scenes
    from benchmark.reference import fragments

    entry = core.benchmark()["configs"][0]
    cfg = Config.fromfile(os.path.join(core.ROOT, entry["file"]))
    written = scenes.write_scannet_scenes(str(tmp_path), "val", 1, 3000, 2 ** 31 + 9)
    test = dict(cfg.data.test, data_root=str(tmp_path))
    frags = build_dataset(test)[0]["fragment_list"]
    scene = fragments.Pipeline.from_config(test).scene(written[0])

    def held(f, grid=None):
        return fragments.Fragment(np.zeros(len(f["index"]), np.int64),
                                  f["grid_coord"] if grid is None else grid,
                                  f["feat"], f["index"])

    assert len(frags) == sum(r.fragments for r in scene.rotations) > 4
    for k, f in enumerate(frags):
        assert fragments.mismatch(scene, fragments.rotation_of(scene, k), held(f))[0] == 0
    assert fragments.coverage_mismatch(scene, [f["index"] for f in frags]) == 0
    moved = frags[0]["grid_coord"].copy()
    moved[0, 0] += 1
    assert fragments.mismatch(scene, 0, held(frags[0], moved))[0] > 0
    assert fragments.coverage_mismatch(scene, [f["index"] for f in frags[1:]]) > 0


def test_reference_matches_the_program_on_the_cpu():
    """One training forward and backward of the recipe's segmentor at a
    small size, both sides in float64: logits, loss and every leaf's
    gradient agree to rounding. (In f32 the coarsest level's few rows
    amplify rounding in its norms' gradients to ~1e-3.)"""
    from ponderv2_tpu_torch.models import build_model

    from benchmark.harness import weights

    backbone = dict(type="SpUNet-v1m1", in_channels=9, num_classes=20,
                    channels=(32, 64, 128, 256, 256, 128, 96, 96),
                    layers=(2, 3, 4, 6, 2, 2, 2, 2), capacities=(4096,) * 5)
    crit = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
            dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)]
    model = build_model(dict(type="DefaultSegmentor", backbone=backbone, criteria=crit))
    arch = ref.arch_from_config(backbone)
    params = {k: v.double() for k, v in
              weights.seeded_params(ref.param_specs(arch), 7, "cpu").items()}
    model.load_state_dict(params)
    model.double().train()
    rng = np.random.RandomState(0)
    coords = np.unique(np.concatenate([
        np.stack([np.full(1500, b), *(rng.randint(0, 96, (3, 1500)))], 1)
        for b in range(2)]), axis=0)
    n = len(coords)
    feat = rng.randn(n, 9)
    seg = rng.randint(-1, 20, n)
    pad = 4096 - n
    batch = dict(feat=torch.as_tensor(np.concatenate([feat, np.zeros((pad, 9))])),
                 grid_coord=torch.as_tensor(np.concatenate(
                     [coords[:, 1:], -np.ones((pad, 3), np.int64)]).astype(np.int32)),
                 batch=torch.as_tensor(np.concatenate([coords[:, 0], -np.ones(pad, np.int64)])
                                       .astype(np.int32)),
                 segment=torch.as_tensor(np.concatenate([seg, -np.ones(pad, np.int64)])),
                 spatial_shape=(128, 128, 128), batch_size=2)
    out = model(batch)
    out["loss"].backward()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items() if ref.trainable(k)}
    logits = ref.forward(arch, {**params, **leaves}, torch.as_tensor(feat),
                         ref.build_plans(torch.as_tensor(coords)), True, ref.Precision())
    loss = ref.seg_loss(logits, torch.as_tensor(seg))
    loss.backward()
    scale = float(logits.detach().abs().max())
    assert float((out["seg_logits"][:n] - logits).abs().max()) < 1e-12 * scale
    assert float(out["loss"]) == pytest.approx(float(loss), rel=1e-12)
    # each leaf's gradient against its norm or the median leaf's
    grads = dict(model.named_parameters())
    median = float(torch.stack([leaf.grad.norm() for leaf in leaves.values()]).median())
    for k, leaf in leaves.items():
        gap = float((grads[k].grad - leaf.grad).norm()) / max(float(leaf.grad.norm()), median)
        assert gap < 1e-9, k
