# ScanNet SpUNet-v1m1 semantic-segmentation training at full width and
# depth on procedural scenes: the base config unchanged (model, criteria,
# optimizer, scheduler, batch 12, point budget, mix_prob, sparse_shape,
# train/val transforms) except the data, which are 36 synthetic
# ScanNet-scale training scenes (100k points each, 3 steps of 12) and 2 such
# val scenes, and one epoch with one evaluation.
_base_ = ["../scannet/semseg-spunet-v1m1-0-base.py"]

epoch = 1
eval_epoch = 1

data = dict(
    train=dict(
        _delete_=True,
        type="SyntheticDataset",
        num_scenes=36,
        points_per_scene=100_000,
        num_classes=20,
        transform=[
            dict(type="CenterShift", apply_z=True),
            dict(type="RandomDropout", dropout_ratio=0.2, dropout_application_ratio=0.2),
            dict(type="RandomRotate", angle=[-1, 1], axis="z", center=[0, 0, 0], p=0.5),
            dict(type="RandomRotate", angle=[-1 / 64, 1 / 64], axis="x", p=0.5),
            dict(type="RandomRotate", angle=[-1 / 64, 1 / 64], axis="y", p=0.5),
            dict(type="RandomScale", scale=[0.9, 1.1]),
            dict(type="RandomFlip", p=0.5),
            dict(type="RandomJitter", sigma=0.005, clip=0.02),
            dict(type="ElasticDistortion", distortion_params=[[0.2, 0.4], [0.8, 1.6]]),
            dict(type="ChromaticAutoContrast", p=0.2, blend_factor=None),
            dict(type="ChromaticTranslation", p=0.95, ratio=0.05),
            dict(type="ChromaticJitter", p=0.95, std=0.05),
            dict(type="GridSample", grid_size=0.02, hash_type="fnv", mode="train",
                 return_grid_coord=True),
            dict(type="SphereCrop", point_max=100000, mode="random"),
            dict(type="CenterShift", apply_z=False),
            dict(type="NormalizeColor"),
            dict(type="ShufflePoint"),
            dict(type="Collect", keys=("coord", "grid_coord", "segment"),
                 feat_keys=("color", "normal", "coord")),
        ],
    ),
    val=dict(
        _delete_=True,
        type="SyntheticDataset",
        num_scenes=2,
        points_per_scene=100_000,
        num_classes=20,
        transform=[
            dict(type="CenterShift", apply_z=True),
            dict(type="GridSample", grid_size=0.02, hash_type="fnv", mode="train",
                 return_grid_coord=True),
            dict(type="CenterShift", apply_z=False),
            dict(type="NormalizeColor"),
            dict(type="Collect", keys=("coord", "grid_coord", "segment"),
                 feat_keys=("color", "normal", "coord")),
        ],
    ),
)
