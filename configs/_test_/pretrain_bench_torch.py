# bench.py's pretrain workload for the PyTorch port: configs/_test_/
# pretrain_bench.py's model and data (PonderIndoor-v2: SpUNet-v1m1 at
# channels 32-256 with bench.py's per-level capacities, UNet3D-v1m2 on a
# 128x128x32 volume, NeuS with 96 + 36 samples and 1 upsample step, 5 views
# x 256 rays per scene, the render + CLIP-semantic + PPT losses, bf16
# compute; SGD with OneCycle; batch 2 of 100k-point synthetic RGB-D scenes),
# with the compute dtype named as a string, so that the config loads without
# JAX, and with the backbone's ``remat`` off, as the JAX bench config sets
# it (autograd keeps the activations; the step peaks at ~15 GiB). The one cut is the run's length:
# 6 scenes, one epoch, 3 steps.
_base_ = ["../_base_/default_runtime.py"]

num_classes = 20
names = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refridgerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
]

batch_size = 2
num_worker = 0
evaluate = False
epoch = 1  # 6 scenes / bs2 = 3 steps
eval_epoch = 1
point_budget = 204_800
sparse_shape = (544, 544, 192)
host_plans = True  # accepted; the port builds plans on the device
metric_keys = ("rgb_loss", "depth_loss", "semantic_loss", "psnr")

model = dict(
    type="PonderIndoor-v2",
    backbone=dict(
        type="SpUNet-v1m1",
        in_channels=6,
        num_classes=0,
        channels=(32, 64, 128, 256, 256, 128, 96, 96),
        layers=(2, 3, 4, 6, 2, 2, 2, 2),
        capacities=(204800, 102400, 40960, 10240, 2560),
        compute_dtype="bfloat16",
        remat=False,
    ),
    projection=dict(type="UNet3D-v1m2", in_channels=96, out_channels=128,
                    f_maps=32, num_levels=4, compute_dtype="bfloat16"),
    renderer=dict(
        type="NeuSModel",
        field=dict(hidden_dim=128, num_layers=2, geo_feat_dim=64,
                   semantic_dim=512, share_volume=False,
                   compute_dtype="bfloat16"),
        collider=dict(type="AABBBoxCollider", near_plane=0.01),
        sampler=dict(type="NeuSSampler", num_samples=96,
                     num_samples_importance=36, num_upsample_steps=1),
        loss=dict(
            sensor_depth_truncation=0.05,
            temperature=0.01,
            weights=dict(eikonal_loss=0.01, free_space_loss=1.0,
                         sdf_loss=10.0, depth_loss=1.0, rgb_loss=10.0,
                         semantic_loss=0.1, sparse_sdf=0.0),
        ),
    ),
    grid_shape=(128, 128, 32),
    grid_size=0.02,
    assume_sorted=True,
    ray_nsample=256,
    padding=0.1,
    pool_type="mean",
    render_semantic=True,
    conditions=("ScanNet",),
    class_name=tuple(names),
    valid_index=(tuple(range(num_classes)),),
    ppt_loss_weight=1.0,
)

optimizer = dict(type="SGD", lr=0.0005, momentum=0.9, weight_decay=0.0001)
scheduler = dict(type="OneCycleLR", max_lr=0.0005, pct_start=0.3)

data = dict(
    num_classes=num_classes,
    ignore_index=-1,
    names=names,
    train=dict(
        type="SyntheticRGBDDataset",
        num_scenes=6,
        points_per_scene=100_000,
        num_classes=num_classes,
        num_cameras=5,
        image_size=240,
        seed=0,
        transform=[
            dict(type="CenterShift", apply_z=True, keys=["extrinsic"]),
            dict(type="PositiveShift"),
            dict(type="GridSample", grid_size=0.02, hash_type="fnv",
                 mode="train", return_grid_coord=True),
            dict(type="NormalizeColor"),
            dict(type="Collect",
                 keys=("coord", "grid_coord", "segment", "rgb", "depth",
                       "semantic2d", "intrinsic", "extrinsic"),
                 feat_keys=("color", "normal")),
        ],
    ),
)
