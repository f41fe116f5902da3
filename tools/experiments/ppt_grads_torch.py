"""Where the PPT recipe's step grads differ between the kernels and their
plain versions, and how far each f32 path is from float64.

    python tools/experiments/ppt_grads_torch.py

Needs one CUDA GPU. Trains the recipe 3 steps on written scenes as
``chip_smoke.py`` phase 14 does, then, from the trained state and from the
seeded one, runs one step's forward and backward with the kernels, with
the plain versions, with the plain versions summing in another order
(``chip_smoke.py:reordered_*``), with the plain versions in float64
(``chip_smoke.py:float64_step_grads``) and once more with the kernels, each
K1-K3 call held against float64 and plain f32 on its own inputs
(``chip_smoke.py:float64_cores``). Prints every call's errors and the
largest ratio rho of kernel to plain f32 error, then the grads closest to
phase 8's bound (``grad_rel`` 1e-3 of max|ref| plus 3x the reordered
difference) and to phase 14's (the same with 3 rho x the plain path's
float64 difference, the kernels held against plain and against float64),
each with its kernel, reordered and float64 differences.
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ppt_grads_torch: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ponderv2_tpu_torch.engines.defaults import default_config_parser
    from ponderv2_tpu_torch.models import build_model
    from ponderv2_tpu_torch.ops import band_conv as bc
    from ponderv2_tpu_torch.ops import windowed_gather as wg
    from ponderv2_tpu_torch.ops.cuda_build import load_libraries

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    load_libraries(*sorted({k.source for k in bc.KERNELS + wg.KERNELS}))
    for module in (bc, wg):
        module.build_kernels()

    tmp = tempfile.mkdtemp(prefix="ppt_grads_")
    try:
        data_root = os.path.join(tmp, "data")
        cs.write_scannet_scenes(data_root, cs.PPT_TRAIN_SCENES, 1)
        cfg = default_config_parser(cs.PPT_CONFIG, cs.ppt_recipe_options(
            data_root, os.path.join(tmp, "train")))
        cfg.seed = cs.SEED
        cfg.device = "cuda"
        run = cs.train_and_check("ppt", cfg, dev)
        trained, inputs = run.state, run.b_inputs
        del run
        torch.cuda.empty_cache()

        plain = {n: getattr(bc, f"{n}_plain") for n in cs.BAND_CORES}
        reordered = {"band_fwd_core": cs.reordered_fwd, "band_dxdw_core": cs.reordered_dxdw,
                     "band_dw_core": cs.reordered_dw}

        for tag, state in (("trained", trained), ("seeded", None)):
            model = build_model(dict(cfg.model))
            if state is None:
                model.reset_parameters(torch.Generator().manual_seed(cs.SEED))
            else:
                model.load_state_dict(state)
            model.to(dev).train()
            k = cs.step_grads(model, inputs)
            p = cs.step_grads(model, inputs, plain)
            r = cs.step_grads(model, inputs, reordered)
            calls = []
            cs.step_grads(model, inputs, cs.float64_cores(calls))
            loss64, g64, peak = cs.float64_step_grads(model, inputs)
            print(f"[calls] {tag}: K1-K3 outputs in step order (rows, cin, cout): kernel and "
                  "plain f32 error against float64, as a share of 3 x 2^-22 x max "
                  "sum|products|; kernel / plain")
            rho = 1.0
            for name, n, cin, cout, e_k, e_p, m in calls:
                ratio = e_k / max(e_p, 2.0 ** -24 * m)
                rho = max(rho, ratio)
                print(f"[calls]   {name} {n} {cin}->{cout}: "
                      f"{e_k / (cs.TILE_F32_ACCURACY * m):.3f} "
                      f"{e_p / (cs.TILE_F32_ACCURACY * m):.3f}; {ratio:.2f}x")
            rows = []
            for name, ref in p[1].items():
                scale = ref.abs().max().item()
                kp = (k[1][name] - ref).abs().max().item()
                rp = (r[1][name] - ref).abs().max().item()
                p64 = (g64[name] - ref.double()).abs().max().item()
                k64 = (g64[name] - k[1][name].double()).abs().max().item()
                m64 = max(kp, k64) / max(1e-3 * scale + 3 * rho * p64, 1e-30)
                rows.append((kp / max(1e-3 * scale + 3 * rp, 1e-30), m64,
                             *(x / max(scale, 1e-30) for x in (kp, rp, p64, k64)), name))
            print(f"[grads] {tag}: loss kernel {k[0]:.9f} plain {p[0]:.9f} reordered "
                  f"{r[0]:.9f} float64 {loss64:.9f}; float64 step peak {peak:.3f} GiB; "
                  f"rho {rho:.3f}; over phase 8's bound {sum(x[0] > 1 for x in rows)}, over "
                  f"phase 14's {sum(x[1] > 1 for x in rows)} of {len(rows)} grads")
            for key, label in ((0, "phase 8's (reordered)"), (1, "phase 14's (float64)")):
                rows.sort(key=lambda x: x[key])
                print(f"[grads]   closest to {label} bound (margin phase 8, margin phase "
                      "14; of max|ref|: kernel-plain, reordered-plain, float64-plain, "
                      "float64-kernel):")
                for mr, mf, kp, rp, p64, k64, name in rows[-6:]:
                    print(f"[grads]     {name}: {mr:.3f} {mf:.3f}; {kp:.3e} {rp:.3e} "
                          f"{p64:.3e} {k64:.3e}")
            del model, k, p, r, g64
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
