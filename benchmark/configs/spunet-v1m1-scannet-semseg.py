# SpUNet-v1m1 fine-tuned for ScanNet semantic segmentation: a frozen copy
# of this repository's configs/scannet/semseg-spunet-v1m1-0-base.py (the
# port's translation of PonderV2's recipe of that name, github.com/
# OpenGVLab/PonderV2, arXiv 2310.08586) with its _base_
# (configs/_base_/default_runtime.py) merged in, so that a later edit there
# does not move the benchmark.
#
# Every width, depth, loss, optimizer, schedule, batch, Mix3D probability
# and transform is the recipe's. What a run changes is listed under
# `reduced`; the harness applies exactly these overrides. What the
# translation adds to the published file, and what this copy states that
# the published file leaves to the runtime, is listed under `assumed`.

source = "https://github.com/OpenGVLab/PonderV2/blob/main/configs/scannet/semseg-spunet-v1m1-0-base.py"
reduced = {
    "data": "the data roots point at procedural 100k-point box rooms written from the "
            "run's seed in ScanNet's processed .pth layout (the repository holds no scan)",
    "weight": "the checkpoint of seeded weights the benchmark writes",
    "save_path": "the run's scratch directory",
    "seed": "the run's --seed (mod 2**31)",
}
assumed = {
    "point_budget": "the port's: every batch padded to this many rows (static shapes); "
                    "the published recipe pads nothing. The tester pads each fragment to "
                    "it too, as the recipe sets no point_budget_test",
    "point_budget_val": "the port's, as point_budget, for the epoch-end evaluation",
    "sparse_shape": "the port's: the voxel grid's extent, which spconv works out per batch",
    "allow_tf32": "False: f32 products in f32. The published test path (PonderV2's "
                  "SemSegTester, after Pointcept) runs the forward in f32 with no autocast; "
                  "the published training recipe's AMP setting (enable_amp, applied by "
                  "its trainer's autocast) is not in this repository's translation and "
                  "was not checked against the published file",
}

allow_tf32 = False

weight = None  # path to model weight
resume = False  # resume training from weight
evaluate = True  # evaluate after each eval epoch
test_only = False

seed = None  # filled by default_config_parser with a shared random seed
save_path = "exp/default"
num_worker = 0
batch_size = 2  # global batch size (sharded across devices)
batch_size_val = 1
batch_size_test = 1

epoch = 2  # total data epochs
eval_epoch = 2  # outer epochs (data loops epoch // eval_epoch times)

mix_prob = 0.0
param_dicts = None

train = dict(type="Trainer")
test = dict(type="SemSegTester")

hooks = [
    dict(type="CheckpointLoader"),
    dict(type="IterationTimer", warmup_iter=2),
    dict(type="InformationWriter"),
    dict(type="SemSegEvaluator"),
    dict(type="CheckpointSaver", save_freq=None),
]

num_classes = 20
names = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
]

batch_size = 12
batch_size_val = 1
num_worker = 12
mix_prob = 0.8
epoch = 800
eval_epoch = 100
point_budget = 1_572_864  # 12 scenes x ~120k voxels, padded
point_budget_val = 262_144
sparse_shape = (1024, 1024, 512)

model = dict(
    type="DefaultSegmentor",
    backbone=dict(
        type="SpUNet-v1m1",
        in_channels=9,
        num_classes=num_classes,
        channels=(32, 64, 128, 256, 256, 128, 96, 96),
        layers=(2, 3, 4, 6, 2, 2, 2, 2),
    ),
    criteria=[
        dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
        dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1),
    ],
)

optimizer = dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=1e-4, nesterov=True)
scheduler = dict(type="OneCycleLR", max_lr=0.05, pct_start=0.05,
                 anneal_strategy="cos", div_factor=10.0, final_div_factor=10000.0)

data = dict(
    num_classes=num_classes,
    ignore_index=-1,
    names=names,
    train=dict(
        type="ScanNetDataset",
        split="train",
        data_root="data/scannet",
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
        test_mode=False,
    ),
    val=dict(
        type="ScanNetDataset",
        split="val",
        data_root="data/scannet",
        transform=[
            dict(type="CenterShift", apply_z=True),
            dict(type="GridSample", grid_size=0.02, hash_type="fnv", mode="train",
                 return_grid_coord=True),
            dict(type="CenterShift", apply_z=False),
            dict(type="NormalizeColor"),
            dict(type="Collect", keys=("coord", "grid_coord", "segment"),
                 feat_keys=("color", "normal", "coord")),
        ],
        test_mode=False,
    ),
    test=dict(
        type="ScanNetDataset",
        split="val",
        data_root="data/scannet",
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
