"""Where one ScanNet-scale fragment's serving time goes, on a CUDA GPU.

    python tools/profile_semseg_torch.py [--out DIR]

Builds the port's SpUNet-v1m1 from
``configs/_test_/semseg_spunet_scannet_synthetic.py`` with the seeded,
BN-calibrated weights ``chip_smoke.py`` uses, takes the first fragment of
scene 0, and prints (as one JSON line) the host-clock medians of its phases
(collate, host-to-device copy, plan build, backbone, whole forward, copy in
+ forward + logits back), then device busy time and K1's share from a
``torch.profiler`` trace of 3 forwards. ``--out`` also writes the profiler
table and a Chrome trace there.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def median_ms(fn, n=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return 1e3 * float(np.median(times))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="directory for table + trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_semseg_torch: needs a CUDA GPU")
    import chip_smoke
    from ponderv2_tpu_torch.datasets import build_dataset, collate_fn
    from ponderv2_tpu_torch.engines.common import split_batch
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.models.default import batch_to_sparse_tensor
    from ponderv2_tpu_torch.models.sparse_unet.plans import (
        build_spunet_plans_auto, capacity_schedule)
    from ponderv2_tpu_torch.utils.config import Config

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = Config.fromfile(chip_smoke.CONFIG)
    model = build_model(dict(cfg.model))
    frag = build_dataset(dict(cfg.data.test))[0]["fragment_list"][0]
    t = time.perf_counter()
    batch = collate_fn([dict(frag)], point_budget=cfg.point_budget_test,
                       scene_budget=1)
    collate_ms = 1e3 * (time.perf_counter() - t)
    arrays, _ = split_batch(batch)

    def to_device():
        d = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
        d.update(spatial_shape=tuple(cfg.sparse_shape), batch_size=1)
        return d

    inputs = to_device()
    model.load_state_dict(chip_smoke.seeded_state_dict(model, inputs, dev))
    model.eval()
    spunet = model.backbone
    st = batch_to_sparse_tensor(inputs)
    caps = capacity_schedule(st.capacity, spunet.num_stages)

    def plans():
        return build_spunet_plans_auto(st.coords, st.spatial_shape, 1, caps,
                                       spunet.channels)

    with torch.inference_mode():
        built = plans()
        phases = dict(
            collate_ms=collate_ms,
            h2d_ms=median_ms(to_device),
            plans_ms=median_ms(plans),
            backbone_given_plans_ms=median_ms(lambda: spunet(st, built)),
            model_forward_ms=median_ms(lambda: model(inputs)),
            h2d_forward_d2h_ms=median_ms(
                lambda: model(to_device())["seg_logits"].cpu()),
        )
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model(inputs)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 3e3
    k1 = sum(e.self_device_time_total for e in kernels
             if "band_fwd_kernel" in e.key) / 3e3
    phases.update(device_busy_ms=busy, k1_ms=k1,
                  kernels_per_forward=sum(e.count for e in kernels) / 3,
                  idle_share=1.0 - busy / phases["model_forward_ms"])
    print(json.dumps(phases))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_table.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40,
                max_name_column_width=80))
        prof.export_chrome_trace(os.path.join(args.out, "fragment_trace.json"))


if __name__ == "__main__":
    main()
