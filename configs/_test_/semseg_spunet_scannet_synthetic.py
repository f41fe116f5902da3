# ScanNet SpUNet-v1m1 semantic segmentation at full width on procedural
# scenes: the base config unchanged except the test data, which are two
# synthetic ScanNet-scale scenes (100k points each) under the ScanNet test
# transform and test_cfg (grid 0.02, 4 z-rotations, test-mode GridSample).
_base_ = ["../scannet/semseg-spunet-v1m1-0-base.py"]

point_budget_test = 131072

data = dict(
    test=dict(
        _delete_=True,
        type="SyntheticDataset",
        num_scenes=2,
        points_per_scene=100_000,
        num_classes=20,
        transform=[
            dict(type="CenterShift", apply_z=True),
            dict(type="NormalizeColor"),
        ],
        test_mode=True,
        test_cfg=dict(
            voxelize=dict(type="GridSample", grid_size=0.02, hash_type="fnv",
                          mode="test", return_grid_coord=True,
                          keys=("coord", "color", "normal")),
            crop=None,
            post_transform=[
                dict(type="CenterShift", apply_z=False),
                dict(type="Collect", keys=("coord", "grid_coord", "index"),
                     feat_keys=("color", "normal", "coord")),
            ],
            aug_transform=[
                [dict(type="RandomRotateTargetAngle", angle=[0], axis="z",
                      center=[0, 0, 0], p=1)],
                [dict(type="RandomRotateTargetAngle", angle=[1 / 2], axis="z",
                      center=[0, 0, 0], p=1)],
                [dict(type="RandomRotateTargetAngle", angle=[1], axis="z",
                      center=[0, 0, 0], p=1)],
                [dict(type="RandomRotateTargetAngle", angle=[3 / 2], axis="z",
                      center=[0, 0, 0], p=1)],
            ],
        ),
    ),
)
