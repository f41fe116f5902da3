"""PyTorch port vs JAX package: the nuScenes data path and the outdoor
entry points on the CPU.

- the procedural writer (``datasets/preprocessing/synthetic_nuscenes.py``):
  its files read by the JAX ``NuScenesDataset`` and by the port's, with
  equal arrays (values and dtypes), cameras on and off;
- the copied transforms (``PointRangeFilter``, ``ProjectOnImage``,
  ``RaySample``) and the dataset byte-equal to the JAX sources but for the
  repairs named here, and the outdoor pipelines' outputs equal under one
  ``np.random.seed``;
- F10: ``RandomShift`` on the nuScenes configs' ``shift=[0.5, 0.5, 0.5]``;
- F11: a test scan's labels taken after ``PointRangeFilter``;
- the PNG reader against imageio and PIL over every row filter;
- ``CheckpointLoader``'s weight load, and ``chip_smoke.py`` phases 17-18's
  configs.

``tools/train_torch.py`` on the four outdoor pretrain configs and on the
nuScenes semseg config from the pretrain's checkpoint, and
``tools/test_torch.py`` on the fine-tuned weights, cut to test widths, are
in ``test_torch_nuscenes_train.py`` (the base config and the semseg from
its checkpoint) and ``test_torch_nuscenes_pretrain.py`` (the other three
pretrain configs).
"""

import inspect
import os
import pickle
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

import ponderv2_tpu.datasets.nuscenes as jnus
import ponderv2_tpu.datasets.transform as jtr
import ponderv2_tpu_torch.datasets.defaults as tdef
import ponderv2_tpu_torch.datasets.nuscenes as tnus
import ponderv2_tpu_torch.datasets.transform as ttr
from ponderv2_tpu_torch.datasets import collate_fn
from ponderv2_tpu_torch.datasets.image_io import read_image, read_png, write_png
from ponderv2_tpu_torch.datasets.preprocessing import synthetic_nuscenes as syn
from ponderv2_tpu_torch.utils.config import Config
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
PRETRAIN = {name: os.path.join(ROOT, f"configs/nuscenes/pretrain-ponder-spunet-v1m1-0-{name}.py")
            for name in ("base", "base-color", "base-color-amp", "base-semantic")}
SEMSEG = os.path.join(ROOT, "configs/nuscenes/semseg-ppt-v1m1-0-nu-sk-wa-spunet-ft.py")
IMAGE_HW = (96, 160)  # small cameras for the CPU; the chip runs 900 x 1600
RANGE = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
# test widths of SpUNet-v1m1 and of the render head
SMALL = {"model.backbone.channels": (8, 16, 16, 16, 16, 16, 8, 8),
         "model.backbone.layers": (1,) * 8, "model.backbone.base_channels": 8}
SMALL_RENDER = {"model.projection.in_channels": 8, "model.projection.out_channels": 8,
                "model.renderer.field.hidden_dim": 16,
                "model.renderer.sampler.num_samples": 8,
                "model.renderer.sampler.num_samples_importance": 4,
                "model.grid_shape": ((36, 36, 5),)}


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """Two train scans and one val scan with cameras, one scan without."""
    root = str(tmp_path_factory.mktemp("nuscenes"))
    infos = syn.write_synthetic_nuscenes(root, {"train": 2, "val": 1}, seed=0,
                                         image_hw=IMAGE_HW)
    bare = str(tmp_path_factory.mktemp("nuscenes_bare"))
    syn.write_synthetic_nuscenes(bare, {"train": 1}, seed=0, cameras=False)
    return root, bare, infos


def _assert_same(a, b, where=""):
    assert sorted(a) == sorted(b), where
    for k in a:
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        assert va.dtype == vb.dtype and va.shape == vb.shape, (where, k)
        assert np.array_equal(va, vb), (where, k)


# ------------------------------------------------------------------ the writer


def test_writer_scan_layout_and_counts(scans):
    """A full-size keyframe: 25-35k points of (x, y, z, intensity, ring)
    float32, raw lidarseg ids that the learning map knows, intensity in
    0-255, 32 rings; six cameras with ``lidar2img = K @ lidar2cam``; the
    same seed writes the same bytes."""
    root, bare, infos = scans
    info = pickle.load(open(os.path.join(
        bare, "info", "nuscenes_infos_10sweeps_train.pkl"), "rb"))[0]
    pts = np.fromfile(os.path.join(bare, "raw", info["lidar_path"]), np.float32).reshape(-1, 5)
    lab = np.fromfile(os.path.join(bare, "raw", info["gt_segment_path"]), np.uint8)
    assert 25_000 <= len(pts) <= 35_000 and len(lab) == len(pts)
    assert set(np.unique(lab)) <= set(tnus.LEARNING_MAP)
    assert pts[:, 3].min() >= 0 and pts[:, 3].max() <= 255
    assert set(np.unique(pts[:, 4]).astype(int)) <= set(range(32))
    assert np.linalg.norm(pts[:, :3], axis=1).max() <= syn.MAX_RANGE + 0.2
    assert "cams" not in info
    cams = infos["train"][0]["cams"]
    assert list(cams) == [name for name, _ in syn.CAMERAS]
    for cam in cams.values():
        P = np.eye(4)
        P[:3, :3] = cam["cam_intrinsic"]
        assert np.allclose(cam["lidar2img"], P @ cam["lidar2cam"])
        img = read_png(os.path.join(root, "raw", cam["data_path"]))
        assert img.shape == (*IMAGE_HW, 3) and img.dtype == np.uint8
    again = syn.write_scan(str(os.path.join(bare, "again")), "x", (0, 0, 0), cameras=False)
    assert open(os.path.join(bare, "again", "raw", again["lidar_path"]), "rb").read() == open(
        os.path.join(bare, "raw", info["lidar_path"]), "rb").read()


@pytest.mark.parametrize("split,use_camera", [("train", True), ("train", False),
                                              ("val", True)])
def test_datasets_read_the_writer_files_alike(scans, split, use_camera):
    """``get_data`` of the port's dataset equals the JAX dataset's (which
    reads the PNGs with imageio), array for array."""
    root = scans[0]
    kw = dict(split=split, data_root=root, use_camera=use_camera)
    jds, tds = jnus.NuScenesDataset(**kw), tnus.NuScenesDataset(**kw)
    assert len(jds) == len(tds) > 0
    for i in range(len(tds)):
        a, b = jds.get_data(i), tds.get_data(i)
        _assert_same(a, b, f"{split} {i}")
        assert ("rgb" in b) == use_camera
        assert tds.get_data_name(i) == jds.get_data_name(i)


# ---------------------------------------------------------- sources, repairs


def test_copied_sources_are_the_jax_ones():
    """``PointRangeFilter``, ``ProjectOnImage``, ``RaySample``,
    ``LEARNING_MAP`` and ``CLASS_NAMES_16`` are the JAX package's; the
    dataset's ``__init__``, ``get_data_list`` and ``get_data_name`` too, and
    ``get_data`` but for the image reader (``read_image`` for imageio);
    its ``prepare_test_data`` (F11) is ``DefaultDataset``'s but for the
    transform run before ``segment`` is taken out."""
    for name in ("PointRangeFilter", "ProjectOnImage", "RaySample"):
        assert inspect.getsource(getattr(ttr, name)) == inspect.getsource(getattr(jtr, name))
    assert tnus.LEARNING_MAP == jnus.LEARNING_MAP
    assert tnus.CLASS_NAMES_16 == jnus.CLASS_NAMES_16
    T, J = tnus.NuScenesDataset, jnus.NuScenesDataset
    for name in ("__init__", "get_data_list", "get_data_name"):
        assert inspect.getsource(getattr(T, name)) == inspect.getsource(getattr(J, name))
    jsrc = inspect.getsource(J.get_data).replace(
        "            import imageio.v2 as imageio\n\n", "").replace(
        "imageio.imread(", "read_image(")
    assert inspect.getsource(T.get_data) == jsrc
    assert "prepare_test_data" not in J.__dict__
    base = inspect.getsource(tdef.DefaultDataset.prepare_test_data)
    reordered = base.replace(
        "        data_dict = self.get_data(idx)\n"
        "        segment = data_dict.pop(\"segment\", None)\n"
        "        data_dict = self.transform(data_dict)\n",
        "        data_dict = self.transform(self.get_data(idx))\n"
        "        segment = data_dict.pop(\"segment\", None)\n").replace(
        "-> Dict[str, Any]:\n", "-> Dict[str, Any]:\n"
        "        \"\"\"``DefaultDataset.prepare_test_data`` with the transform run before\n"
        "        ``segment`` is taken out (F11).\"\"\"\n", 1)
    assert reordered.count("self.transform(self.get_data(idx))") == 1
    assert inspect.getsource(T.prepare_test_data) == reordered


def test_random_shift_scalar_range_port_only():
    """F10: the JAX transform raises on the configs' ``shift=[0.5, 0.5,
    0.5]``; the port's draws each axis in [-0.5, 0.5] and moves the cameras
    with the points (each camera maps every point to the same pixel as
    before); on ``(lo, hi)`` pairs it draws what the JAX transform draws."""
    rng = np.random.RandomState(0)
    coord = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    l2c, K = syn.camera(55.0)
    P = np.eye(4)
    P[:3, :3] = K
    cams = dict(lidar2img=np.stack([P @ l2c] * 2).astype(np.float32),
                lidar2cam=np.stack([l2c] * 2).astype(np.float32))
    cfg = dict(type="RandomShift", shift=[0.5, 0.5, 0.5], keys=["lidar2img", "lidar2cam"])
    with pytest.raises(TypeError):
        jtr.TRANSFORMS.build(dict(cfg))(dict(coord=coord.copy(), **cams))
    shifts = []
    for seed in range(20):
        np.random.seed(seed)
        out = ttr.TRANSFORMS.build(dict(cfg))(dict(coord=coord.copy(),
                                                   **{k: v.copy() for k, v in cams.items()}))
        s = out["coord"] - coord
        assert np.allclose(s, s[0], atol=1e-5) and np.abs(s[0]).max() <= 0.5
        shifts.append(s[0])
        hom = lambda p: np.concatenate([p, np.ones((len(p), 1))], 1)  # noqa: E731
        for key in ("lidar2img", "lidar2cam"):
            before = hom(coord) @ cams[key][0].T
            after = hom(out["coord"]) @ out[key][0].T
            assert np.allclose(after, before, rtol=1e-4, atol=1e-3), key
    assert np.abs(np.asarray(shifts)).max() > 0.3  # the range is used
    pairs = dict(type="RandomShift", shift=((-0.5, 0.5), (-0.2, 0.3), (0, 0.1)),
                 keys=["lidar2img", "lidar2cam"])
    outs = []
    for tr in (jtr, ttr):
        np.random.seed(3)
        outs.append(tr.TRANSFORMS.build(dict(pairs))(
            dict(coord=coord.copy(), **{k: v.copy() for k, v in cams.items()})))
    _assert_same(*outs, "pairs")


def test_test_scan_labels_follow_the_range_filter_port_only(scans):
    """F11: on the semseg config's test pipeline a scan's points beyond the
    range are dropped; the JAX dataset keeps every label (so its tester
    scores the fragments' predictions against labels of other points), the
    port keeps the labels of the points it keeps."""
    root = scans[0]
    cfg = Config.fromfile(SEMSEG)
    test = dict(cfg.data.test, data_root=root, split="train")
    jd, td = (m.NuScenesDataset(**{k: v for k, v in test.items() if k != "type"})
              for m in (jnus, tnus))
    raw = td.get_data(0)
    keep = ttr.TRANSFORMS.build(dict(type="PointRangeFilter", point_cloud_range=RANGE,
                                     padding=0.1))(dict(raw))
    n, m = len(raw["coord"]), len(keep["coord"])
    assert m < n  # the writer's scans reach beyond the range
    a, b = jd[0], td[0]
    assert len(a["segment"]) == n and np.array_equal(a["segment"], raw["segment"])
    assert len(b["segment"]) == m and np.array_equal(b["segment"], keep["segment"])
    for frags in (a["fragment_list"], b["fragment_list"]):
        assert max(int(f["index"].max()) for f in frags) == m - 1
    assert len(a["fragment_list"]) == len(b["fragment_list"])
    for fa, fb in zip(a["fragment_list"], b["fragment_list"]):
        _assert_same(fa, fb, "fragment")


@pytest.mark.parametrize("name", ["base-color", "base-color-amp", "base-semantic"])
def test_pretrain_pipelines_equal_under_one_seed(scans, name):
    """The config's train pipeline on a scan, in each package under
    ``np.random.seed``: equal outputs. The JAX ``RandomShift`` takes
    ``(lo, hi)`` pairs only (F10), so both run with the configs' shift as
    pairs ``(-0.5, 0.5)``; the collated batch keeps the rays per scan,
    (B, 512, 3)."""
    root = scans[0]
    cfg = Config.fromfile(PRETRAIN[name])
    pipeline = []
    for t in cfg.data.train.transform:
        t = dict(t)
        if t["type"] == "RandomShift":
            t["shift"] = [(-s, s) for s in t["shift"]]
        pipeline.append(t)
    data = tnus.NuScenesDataset(split="train", data_root=root, use_camera=True).get_data(0)
    outs = []
    for tr in (jtr, ttr):
        np.random.seed(7)
        outs.append(tr.Compose(pipeline)({k: v.copy() for k, v in data.items()}))
    _assert_same(outs[0], outs[1], name)
    out = outs[1]
    assert out["ray_start"].shape == (512, 3) and out["ray_valid"].all()
    assert out["feat"].shape[1] == 4
    batch = collate_fn([out, out], point_budget=2 * len(out["coord"]) + 10, scene_budget=3)
    assert batch["ray_start"].shape == (3, 512, 3) and batch["ray_end"].shape == (3, 512, 3)
    assert not batch["ray_valid"][2].any()
    assert batch["coord"].shape[0] == 2 * len(out["coord"]) + 10


# ---------------------------------------------------------------- PNG reader


def _png(path, img, filters):
    """Write ``img`` (uint8 H x W x C) with row ``y`` filtered by
    ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        ft = filters[y % len(filters)]
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        rows.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    color = {1: 0, 3: 2, 4: 6}[c]

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                                    0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4])
def test_png_reader_every_filter_type(tmp_path, channels, ft):
    """Rows filtered with each filter type (and all five in turn): the
    reader gives the image, as imageio and PIL do."""
    import imageio.v2 as imageio
    from PIL import Image

    rng = np.random.RandomState(ft * 10 + channels)
    y, x = np.mgrid[:23, :37]
    img = ((x * 5 + y * 3)[..., None] + rng.randint(0, 60, (23, 37, channels))).astype(np.uint8)
    for filters, name in (((ft,), "one"), ((0, 1, 2, 3, 4), "all")):
        path = str(tmp_path / f"{name}.png")
        _png(path, img, filters)
        got = read_png(path)
        want = img[..., 0] if channels == 1 else img
        assert np.array_equal(got, want)
        assert np.array_equal(got, imageio.imread(path))
        assert np.array_equal(got, np.asarray(Image.open(path)))


def test_png_reader_on_pil_files_and_other_formats(tmp_path, monkeypatch):
    """Images PIL writes (adaptive filters: Sub, Up and Paeth rows here) read
    as PIL reads them; ``write_png`` round-trips; 16-bit gray PNG reads as
    PIL reads it; a JPEG reads as PIL decodes it, with PIL blocked too (the
    port's codec); a 1-bit PNG and a file of another format raise."""
    from PIL import Image

    rng = np.random.RandomState(0)
    y, x = np.mgrid[:40, :64]
    img = ((x * 7 + y * 3)[..., None] + rng.randint(0, 40, (40, 64, 3))).astype(np.uint8)
    for mode, arr in (("RGB", img), ("RGBA", np.concatenate([img, img[..., :1]], -1)),
                      ("L", img[..., 0])):
        path = str(tmp_path / f"pil_{mode}.png")
        Image.fromarray(arr, mode).save(path)
        assert np.array_equal(read_png(path), np.asarray(Image.open(path)))
        assert np.array_equal(read_image(path), arr)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    assert np.array_equal(np.asarray(Image.open(path)), img)
    jpg = str(tmp_path / "x.jpg")
    Image.fromarray(img).save(jpg)
    pil_jpg = np.asarray(Image.open(jpg))
    assert np.array_equal(read_image(jpg), pil_jpg)
    wide = str(tmp_path / "wide.png")
    Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(wide)
    assert np.array_equal(read_png(wide), np.asarray(Image.open(wide)))
    one_bit = str(tmp_path / "one_bit.png")
    Image.fromarray(img[..., 0] > 128).save(one_bit)
    with pytest.raises(ValueError, match="bit depth 1"):
        read_png(one_bit)
    bmp = str(tmp_path / "x.bmp")
    Image.fromarray(img).save(bmp)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert np.array_equal(read_image(jpg), pil_jpg)
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        read_image(bmp)


def test_weight_load_skips_absent_names_and_raises_on_a_shape_mismatch():
    """``CheckpointLoader``'s weight load (``load_matching_weights``) takes
    the entries the model names, reports the checkpoint's others as
    skipped and the model's absent ones as missing, and raises on an entry
    of another shape (a 6-channel stem given to a 4-channel model), as
    ``torch.nn.Module.load_state_dict(strict=False)`` does; ``strict``
    raises on skipped or missing entries."""
    from ponderv2_tpu_torch.engines.hooks.misc import load_matching_weights

    def model(cin):
        return torch.nn.ModuleDict({"stem": torch.nn.Linear(cin, 8),
                                    "final": torch.nn.Linear(8, 3)})

    target = model(4)
    ckpt = {k: v for k, v in model(4).state_dict().items() if k.startswith("stem.")}
    ckpt["proj.weight"] = torch.zeros(2, 2)
    report = load_matching_weights(target, ckpt)
    assert report == dict(loaded=["stem.bias", "stem.weight"], skipped=["proj.weight"],
                          missing=["final.bias", "final.weight"])
    assert torch.equal(target.stem.weight, ckpt["stem.weight"])
    with pytest.raises(RuntimeError, match="stem.weight: checkpoint \\(8, 6\\), model \\(8, 4\\)"):
        load_matching_weights(model(4), model(6).state_dict())
    with pytest.raises(KeyError, match="strict weight load"):
        load_matching_weights(model(4), ckpt, strict=True)


def test_chip_smoke_nuscenes_phases_keep_the_configs():
    """``chip_smoke.py`` phases 17-18 change only the configs' data roots,
    epochs, save path, ``num_worker`` and (the fine-tune) ``weight``; the
    one-step configs run on 4 scans, one batch of their batch size."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    allowed = {"data.train.data_root", "data.val.data_root", "data.test.data_root",
               "epoch", "eval_epoch", "save_path", "num_worker", "weight"}
    for config in [*chip_smoke.NUSCENES_PRETRAIN.values(), chip_smoke.NUSCENES_SEMSEG]:
        opts = chip_smoke.nuscenes_options(config, "/data", "/save", 6, "/w.pth")
        assert set(opts) <= allowed
        cfg = Config.fromfile(config)
        assert cfg.num_worker == 16 and 1 <= chip_smoke.nuscenes_num_worker(16) <= 16
    assert chip_smoke.NUSCENES_PRETRAIN == PRETRAIN and chip_smoke.NUSCENES_SEMSEG == SEMSEG
    base = Config.fromfile(PRETRAIN["base"])
    assert chip_smoke.NUSCENES_PRETRAIN_SCANS == 3 * base.batch_size
    assert chip_smoke.NUSCENES_ONE_STEP_SCANS == base.batch_size
    assert chip_smoke.NUSCENES_SEMSEG_SCANS == 3 * Config.fromfile(SEMSEG).batch_size
