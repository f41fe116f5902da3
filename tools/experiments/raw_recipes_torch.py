"""The staged configurations from raw dataset files, on a CUDA GPU.

    python tools/experiments/raw_recipes_torch.py [--recipes NAME ...] [--keep DIR]

What a user does with a download, at each dataset's real widths (only the
counts of scenes, rooms and frames are cut, and the script prints them):

1. write procedural raw files (``ponderv2_tpu_torch/datasets/preprocessing/
   synthetic_raw.py``): ScanNet scans (150k-vertex meshes with labels,
   segments and aggregations, ``.sens`` streams of 1296 x 968 JPEG color and
   640 x 480 depth, label zips, the label tsv and split lists), S3DIS rooms
   (``Annotations/*.txt`` of 300k points, 2D-3D-S frames of 1080 x 1080) and
   Structured3D zips (1024 x 512 panoramas, 1280 x 720 perspective views);
2. run every preprocessor of the port as ``python -m
   ponderv2_tpu_torch.datasets.preprocessing.<name>``, in processes of their
   own: on the card's machine that shows they need nothing but its
   installations (no JAX, PIL, imageio, cv2 or plyfile);
3. time the host: a JPEG decode at 1296 x 968, PNG decodes at 1280 x 720,
   and one scene / room of each preprocessor in this process;
4. train each configuration (``RECIPES``) on those files through
   ``tools/train_torch.py:main_worker`` with ``chip_smoke.py``'s
   ``train_and_check`` (every step's loss finite, ``contract_ok``, lr and
   K1-K3 launches against the routing, the checkpoint), changing only its
   data roots, epochs (``epoch`` 2, ``eval_epoch`` 1: two passes over the
   train set, then one evaluation), ``num_worker``, ``weight=None`` and the
   save path; then its val pass (the recipe's evaluator; a pretrain recipe
   evaluates nothing, so its model renders one view of one scene in eval
   mode, every pixel in ``val_ray_split`` chunks). Per configuration:
   losses, K1-K3 launches a step, step and data-wait ms, peak GiB.

The last line is a JSON object of every number printed. A recipe that
fails is reported with its error and the others run on; the exit code is 1
if any failed. Needs a CUDA GPU.
"""

import argparse
import gc
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

PRE = "ponderv2_tpu_torch.datasets.preprocessing."
SEED = 0
# the counts: each train set one batch of its recipes (12), twice over
SCANNET_TRAIN, SCANNET_VAL, SCANNET_FRAMES = 12, 1, 10
S3DIS_AREAS = {"Area_1": 3, "Area_2": 3, "Area_3": 2, "Area_4": 2, "Area_6": 2, "Area_5": 1}
S3DIS_VIEW_ROOMS, S3DIS_VIEWS = 8, 6  # the pretrain's batch of 8 rooms, 6 views each
S3D_TRAIN_SCENES, S3D_VAL_SCENES, S3D_ROOMS, S3D_PERSPECTIVES = 6, 1, 2, 2
EPOCHS = 2
# name: (config, dataset, kind)
RECIPES = {
    "s3dis-semseg": ("configs/s3dis/semseg-spunet-v1m1-0-base.py", "s3dis", "semseg"),
    "s3dis-ppt": ("configs/s3dis/semseg-ppt-v1m1-0-s3-sc-st-spunet-lovasz-ft.py", "s3dis",
                  "semseg"),
    "s3dis-pretrain": ("configs/s3dis/pretrain-ponder-spunet-v1m1-0-base.py", "s3dis",
                       "pretrain"),
    "structured3d-semseg": ("configs/structured3d/semseg-spunet-v1m1-0-base.py", "structured3d",
                            "semseg"),
    "structured3d-pretrain": ("configs/structured3d/pretrain-ponder-spunet-v1m1-0-base.py",
                              "structured3d", "pretrain"),
    "scannet200-ppt": ("configs/scannet200/semseg-ppt-v1m1-0-spunet-lovasz-ft.py", "scannet",
                       "semseg"),
    "scannet200-insseg": ("configs/scannet200/insseg-ppt-v1m1-0-pointgroup-spunet-ft.py",
                          "scannet", "insseg"),
    "scannet-insseg-pg": ("configs/scannet/insseg-pointgroup-v1m1-0-spunet-base.py", "scannet",
                          "insseg"),
    "scannet-pretrain": ("configs/scannet/pretrain-ponder-spunet-v1m1-0-base.py", "scannet",
                         "pretrain"),
}
# train items per dataset and kind (a pretrain recipe takes the rooms with views)
TRAIN_ITEMS = {("scannet", "semseg"): SCANNET_TRAIN, ("scannet", "insseg"): SCANNET_TRAIN,
               ("scannet", "pretrain"): SCANNET_TRAIN,
               ("s3dis", "semseg"): sum(v for a, v in S3DIS_AREAS.items() if a != "Area_5"),
               ("s3dis", "pretrain"): S3DIS_VIEW_ROOMS,
               ("structured3d", "semseg"): S3D_TRAIN_SCENES * S3D_ROOMS,
               ("structured3d", "pretrain"): S3D_TRAIN_SCENES * S3D_ROOMS}


def write_scannet(raw):
    from ponderv2_tpu_torch.datasets.preprocessing import synthetic_raw as sr

    names = [f"scene{i:04d}_00" for i in range(SCANNET_TRAIN + SCANNET_VAL)]
    sr.write_scannet_meta(raw, {"train": names[:SCANNET_TRAIN], "val": names[SCANNET_TRAIN:]})
    return names


def write_one_scannet(scans, name, seed, frames):
    from ponderv2_tpu_torch.datasets.preprocessing import synthetic_raw as sr

    return sr.write_scannet_scene(scans, name, seed, frames=frames)


def write_one_s3dis_area(root, raw_root, area, views):
    """Every room of one area, ``views[r]`` frames for room r (one process:
    the area's alignment file and camera list are shared by its rooms)."""
    from ponderv2_tpu_torch.datasets.preprocessing import synthetic_raw as sr

    a = int(area.split("_")[1])
    return [sr.write_s3dis_room(root, raw_root, a, f"office_{r + 1}", a * 100 + r, views=v)
            for r, v in enumerate(views)]


def write_one_s3d(root, scene_id, rooms, perspectives):
    from ponderv2_tpu_torch.datasets.preprocessing import synthetic_raw as sr

    return sr.write_structured3d_zip(root, scene_id, scene_id, rooms=rooms,
                                     perspectives=perspectives)


def write_raw(tmp):
    """Every raw file, the jobs spread over the host's CPUs; returns the
    raw roots and the seconds per dataset."""
    raw = {"scannet": os.path.join(tmp, "raw", "scannet"),
           "s3dis": os.path.join(tmp, "raw", "s3dis"),
           "s3dis_2d3ds": os.path.join(tmp, "raw", "s3dis_2d3ds"),
           "structured3d": os.path.join(tmp, "raw", "structured3d")}
    names = write_scannet(raw["scannet"])
    scans = os.path.join(raw["scannet"], "scans")
    jobs = {}
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(os.cpu_count(), mp_context=ctx) as ex:
        jobs["scannet"] = [ex.submit(write_one_scannet, scans, n, i, SCANNET_FRAMES)
                           for i, n in enumerate(names)]
        jobs["s3dis"], with_views = [], 0
        for area, rooms in S3DIS_AREAS.items():
            views = []
            for _ in range(rooms):  # the first S3DIS_VIEW_ROOMS train rooms have views
                views.append(S3DIS_VIEWS if area != "Area_5" and with_views < S3DIS_VIEW_ROOMS
                             else 0)
                with_views += views[-1] > 0
            jobs["s3dis"].append(ex.submit(write_one_s3dis_area, raw["s3dis"],
                                           raw["s3dis_2d3ds"], area, views))
        ids = list(range(S3D_TRAIN_SCENES)) + [3000 + i for i in range(S3D_VAL_SCENES)]
        jobs["structured3d"] = [ex.submit(write_one_s3d, raw["structured3d"], i, S3D_ROOMS,
                                          S3D_PERSPECTIVES) for i in ids]
        done = {}
        for name, futs in jobs.items():
            done[name] = [f.result() for f in futs]
            print(f"[raw] {name}: written by {time.perf_counter() - t0:.1f} s "
                  f"(jobs in parallel on {os.cpu_count()} CPUs)", flush=True)
    counts = done["scannet"][0]
    print(f"[raw] ScanNet: {SCANNET_TRAIN} train + {SCANNET_VAL} val scans of "
          f"{counts['vertices']} vertices / {counts['faces']} faces, {SCANNET_FRAMES} frames "
          f"each (1296 x 968 JPEG color, 640 x 480 depth); cut from ScanNet v2's 1201 + 312 "
          f"scans of ~5,500 frames")
    print(f"[raw] S3DIS: {sum(S3DIS_AREAS.values())} rooms of "
          f"{done['s3dis'][0][0]} points ({', '.join(f'{a} {n}' for a, n in S3DIS_AREAS.items())}),"
          f" {S3DIS_VIEW_ROOMS} with {S3DIS_VIEWS} 2D-3D-S frames of 1080 x 1080; cut from 272 "
          f"rooms in 6 areas")
    print(f"[raw] Structured3D: {S3D_TRAIN_SCENES} train + {S3D_VAL_SCENES} val scenes of "
          f"{S3D_ROOMS} rooms, each a 1024 x 512 panorama and {S3D_PERSPECTIVES} 1280 x 720 "
          f"perspective views; cut from 3,500 scenes of 21,835 rooms")
    return raw


def run_preprocessors(raw, out):
    """The port's preprocessors as ``python -m`` processes, all started
    together; returns each one's wall seconds."""
    workers = str(max(1, (os.cpu_count() or 2) // 2))
    runs = {
        "preprocess_scannet": ["--dataset_root", raw["scannet"], "--output_root",
                               out["scannet"], "--num_workers", workers],
        "sensor_data": ["--scans_path", os.path.join(raw["scannet"], "scans"), "--output_path",
                        out["scannet_rgbd"], "--export_label"],
        "preprocess_s3dis": ["--dataset_root", raw["s3dis"], "--output_root", out["s3dis"],
                             "--raw_root", raw["s3dis_2d3ds"], "--parse_rgbd", "--align_angle",
                             "--point_normals", "--num_workers", workers],
        "preprocess_structured3d": ["--dataset_root", raw["structured3d"], "--output_root",
                                    out["structured3d"], "--parse_rgbd"],
    }
    seconds = {}

    def start(name, args):
        log = open(os.path.join(out["logs"], f"{name}.log"), "w")
        return (subprocess.Popen([sys.executable, "-m", PRE + name, *args], cwd=ROOT,
                                 stdout=log, stderr=subprocess.STDOUT), log, time.perf_counter())

    for batch in (runs, {"preprocess_s3dis_voxelized": [
            "--dataset_root", out["s3dis"], "--output_root", out["s3dis"] + "_voxelized",
            "--voxel_size", "0.01", "--num_workers", workers]}):
        procs = {name: start(name, args) for name, args in batch.items()}
        deadline = time.perf_counter() + 900
        while any(p.poll() is None for p, _, _ in procs.values()):
            for name, (proc, _, t0) in procs.items():
                if proc.poll() is not None and name not in seconds:
                    seconds[name] = time.perf_counter() - t0
            if time.perf_counter() > deadline:
                for proc, _, _ in procs.values():
                    proc.kill()
                raise RuntimeError("the preprocessors ran past 900 s")
            time.sleep(0.1)
        for name, (proc, log, t0) in procs.items():
            rc = proc.wait()
            seconds.setdefault(name, time.perf_counter() - t0)
            log.close()
            with open(log.name) as f:
                tail = f.read()[-2000:]
            print(f"[preprocess] python -m {PRE}{name}: exit {rc} in {seconds[name]:.1f} s",
                  flush=True)
            if rc != 0:
                raise RuntimeError(f"{name} exited {rc}:\n{tail}")
    return seconds


def host_times(raw, out, tmp):
    """Host ms: decodes at the datasets' image sizes, and one scene / room
    of each preprocessor in this process."""
    import zipfile

    import numpy as np

    from ponderv2_tpu_torch.datasets.image_io import decode_jpeg, decode_png
    from ponderv2_tpu_torch.datasets.preprocessing import preprocess_s3dis as ps3
    from ponderv2_tpu_torch.datasets.preprocessing import preprocess_scannet as psc
    from ponderv2_tpu_torch.datasets.preprocessing import preprocess_structured3d as ps3d
    from ponderv2_tpu_torch.datasets.preprocessing import sensor_data as sens

    def median_ms(fn, n=10):
        times = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t))
        return float(np.median(times))

    scene = os.path.join(raw["scannet"], "scans", "scene0000_00")
    stream = sens.SensStream.read(os.path.join(scene, "scene0000_00.sens"))
    jpg = stream.frames[0].color_bytes
    with zipfile.ZipFile(os.path.join(raw["structured3d"], "Structured3D_scene_00000.zip")) as zf:
        base = "Structured3D/scene_00000/2D_rendering/485142/perspective/full/0/"
        rgb_png, depth_png = zf.read(base + "rgb_rawlight.png"), zf.read(base + "depth.png")
    ms = {"jpeg_decode_1296x968": median_ms(lambda: decode_jpeg(jpg)),
          "png_decode_rgb_1280x720": median_ms(lambda: decode_png(rgb_png)),
          "png_decode_depth16_1280x720": median_ms(lambda: decode_png(depth_png))}
    scratch = os.path.join(tmp, "host_times")
    ids = psc.read_category_ids(os.path.join(raw["scannet"], "scannetv2-labels.combined.tsv"))

    def once(fn):
        t = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t)

    ms["scannet_parse_scene"] = once(lambda: psc.parse_scene(
        scene, scratch, "train", category_ids=ids))
    ms["scannet_extract_sens"] = once(lambda: sens.extract_sens(
        os.path.join(scene, "scene0000_00.sens"), os.path.join(scratch, "rgbd", "scene0000_00"),
        label_zip=os.path.join(scene, "scene0000_00_2d-label-filt.zip"),
        label_map_tsv=os.path.join(raw["scannet"], "scannetv2-labels.combined.tsv"),
        scene_meta_txt=os.path.join(scene, "scene0000_00.txt")))
    ms["s3dis_parse_room_with_views"] = once(lambda: ps3.parse_room(
        "Area_1/office_1", 0, raw["s3dis"], raw["s3dis_2d3ds"], scratch, align_angle=True,
        parse_rgbd=True, point_normals=True))
    ms["structured3d_parse_scene"] = once(lambda: ps3d.parse_scene(
        "scene_00000", raw["structured3d"], scratch, parse_rgbd=True))
    print("[host] " + "; ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
          + f" (ScanNet {SCANNET_FRAMES} frames a scan, the S3DIS room {S3DIS_VIEWS} views, "
          f"the Structured3D scene {S3D_ROOMS} rooms)", flush=True)
    shutil.rmtree(scratch, ignore_errors=True)
    return ms


def recipe_options(config, dataset, roots, save_path):
    """Data roots, epochs, ``num_worker`` (the config's, at most the host's
    CPUs less two), ``weight=None`` and the save path."""
    from ponderv2_tpu_torch.utils.config import Config

    cfg = Config.fromfile(os.path.join(ROOT, config))
    opts = {"epoch": EPOCHS, "eval_epoch": 1, "weight": None, "save_path": save_path,
            "num_worker": max(1, min(int(cfg.num_worker), (os.cpu_count() or 3) - 2))}
    for split in ("train", "val", "test"):
        if split in cfg.data and "data_root" in cfg.data[split]:
            opts[f"data.{split}.data_root"] = roots[dataset]
            if "rgbd_root" in cfg.data[split]:
                opts[f"data.{split}.rgbd_root"] = roots["scannet_rgbd"]
    return opts


def eval_render(model, cfg, dev):
    """A pretrain recipe's val pass: one scene of its train set, one view,
    rendered in eval mode (every pixel, ``val_ray_split`` rays a chunk)."""
    import numpy as np
    import torch

    from ponderv2_tpu_torch.datasets import build_dataset, collate_fn
    from ponderv2_tpu_torch.engines.common import split_batch, with_condition

    ds = build_dataset(dict(cfg.data.train))
    item = ds[0]
    views = np.asarray(item["depth"]).shape[0]
    for k, v in list(item.items()):
        if isinstance(v, np.ndarray) and v.ndim >= 3 and v.shape[0] == views and k != "coord":
            item[k] = v[:1]
    batch = collate_fn([item], point_budget=cfg.point_budget, scene_budget=1)
    arrays, static = split_batch(batch)
    inputs = with_condition({k: torch.as_tensor(v, device=dev) for k, v in arrays.items()},
                            static)
    # the trainer's val context (engines/train.py:val_static_ctx)
    inputs.update(spatial_shape=tuple(cfg.get("sparse_shape", (1024, 1024, 1024))),
                  **cfg.get("static_ctx", {}))
    inputs.update(batch_size=1, **cfg.get("static_ctx_val", {}))
    model.eval()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.no_grad():
        out = model(inputs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    rgb = out["render"]["rgb"]
    ok = bool(torch.isfinite(rgb).all()) and bool(out["contract_ok"])
    h, w = np.asarray(item["depth"]).shape[-2:]
    print(f"[val] eval render of one scene's view ({h} x {w} = {rgb.shape[1]} rays, "
          f"{model.val_ray_split} a chunk): {1e3 * secs:.1f} ms, rgb finite and contract_ok "
          f"{ok}, loss {float(out['loss']):.5f}", flush=True)
    if not ok:
        raise RuntimeError("the eval render is not finite or its contract_ok is False")
    return {"eval_render_ms": 1e3 * secs, "rays": int(rgb.shape[1])}


def run_recipe(name, roots, tmp, dev):
    import chip_smoke
    import numpy as np
    import torch

    from ponderv2_tpu_torch.engines.defaults import default_config_parser

    config, dataset, kind = RECIPES[name]
    cfg = default_config_parser(os.path.join(ROOT, config), recipe_options(
        config, dataset, roots, os.path.join(tmp, "runs", name)))
    cfg.seed = SEED
    cfg.device = str(dev)
    steps = TRAIN_ITEMS[(dataset, kind)] * EPOCHS // cfg.batch_size
    records = {"steps": [], "conditions": [], "batches": [], "peaks": []}
    run = chip_smoke.train_and_check(name, cfg, dev, records, val_metric=None,
                                     steps_expected=steps)
    result = {
        "config": config, "batch_size": int(cfg.batch_size), "steps": len(records["steps"]),
        "loss": [float(m["loss"]) for m in records["steps"]],
        "contract_ok": [float(m["contract_ok"]) for m in records["steps"]],
        "launches_per_step": [m["launches"][:3] for m in records["steps"]],
        "step_ms": run.step_times_ms, "data_wait_ms": run.data_ms,
        "peak_gib": run.peak_gib, "step_peak_gib": [p / 2 ** 30 for p in records["peaks"]],
        "live_rows": [int((np.asarray(b["batch"]) >= 0).sum()) for b in records["batches"]],
        "val_forwards": run.n_val, "val": {k: float(v) for k, v in run.val_scalars.items()}}
    print(f"[{name}] val pass: {run.n_val} forwards; " + ", ".join(
        f"{k} {v:.4f}" for k, v in result["val"].items()), flush=True)
    if kind == "pretrain":
        result.update(eval_render(run.model, cfg, dev))
    elif not run.n_val:
        raise RuntimeError(f"{name}: no val forward ran")
    del run, records
    gc.collect()
    torch.cuda.empty_cache()
    return result


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--recipes", nargs="*", default=list(RECIPES), choices=list(RECIPES))
    parser.add_argument("--keep", help="write the raw and preprocessed files here and keep them")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("raw_recipes_torch: needs a CUDA GPU", file=sys.stderr)
        return 2
    from ponderv2_tpu_torch.datasets.image_io import load_codec
    from ponderv2_tpu_torch.models.point_group import cluster
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops.cuda_build import load_libraries

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    load_libraries(*sorted({k.source for k in bc.KERNELS}))
    bc.build_kernels()
    cluster.load_native()
    load_codec()
    print(f"[build] K1-K3, csrc/cluster.cpp and csrc/image_codec.cpp in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    tmp = args.keep or tempfile.mkdtemp(prefix="raw_recipes_")
    summary = {"device": smi, "recipes": {}, "failed": {}}
    try:
        t0 = time.perf_counter()
        raw = write_raw(tmp)
        summary["write_raw_s"] = time.perf_counter() - t0
        out = {k: os.path.join(tmp, "data", k) for k in
               ("scannet", "scannet_rgbd", "s3dis", "structured3d", "logs")}
        os.makedirs(out["logs"], exist_ok=True)
        summary["preprocess_s"] = run_preprocessors(raw, out)
        summary["host_ms"] = host_times(raw, out, tmp)
        for name in args.recipes:
            t = time.perf_counter()
            try:
                summary["recipes"][name] = run_recipe(name, out, tmp, dev)
                summary["recipes"][name]["wall_s"] = time.perf_counter() - t
            except Exception as e:  # report the recipe and run the others
                traceback.print_exc()
                summary["failed"][name] = f"{type(e).__name__}: {e}"[:2000]
                gc.collect()
                torch.cuda.empty_cache()
            print(f"[time] {name}: {time.perf_counter() - t:.1f} s", flush=True)
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)
    summary["wall_s"] = time.perf_counter() - t_start
    for name, r in summary["recipes"].items():
        print(f"[summary] {name}: {r['steps']} steps at batch {r['batch_size']}, loss "
              f"{', '.join(f'{v:.5f}' for v in r['loss'])}; K1-K3 a step "
              f"{r['launches_per_step']}; step {', '.join(f'{v:.1f}' for v in r['step_ms'])} ms; "
              f"data wait {', '.join(f'{v:.1f}' for v in r['data_wait_ms'])} ms; peak "
              f"{r['peak_gib']:.3f} GiB; {r['wall_s']:.1f} s")
    for name, err in summary["failed"].items():
        print(f"[summary] {name}: FAILED {err.splitlines()[0]}")
    print(f"[time] the whole run: {summary['wall_s']:.1f} s")
    print(json.dumps(summary))
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
