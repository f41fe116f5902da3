"""Testing entry point of the PyTorch port (mirrors tools/test.py).

    python tools/test_torch.py --config-file configs/scannet/semseg-spunet-v1m1-0-base.py \
        --options weight=/path/to/state_dict.pth save_path=exp/scannet-test

``weight`` is a file holding the port's SpUNet ``state_dict`` (reference
PyTorch names). Runs on one GPU, or on the CPU with ``device=cpu``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ponderv2_tpu_torch.engines.defaults import (  # noqa: E402
    default_argument_parser,
    default_config_parser,
    default_setup,
)
from ponderv2_tpu_torch.engines.test import TESTERS  # noqa: E402


def main_worker(cfg):
    """Build the configured tester, run it, and return it (its per-forward
    records are read by chip_smoke.py)."""
    cfg = default_setup(cfg)
    tester_cfg = dict(cfg.get("test", {"type": "SemSegTester"}))
    tester_cfg.setdefault("type", "SemSegTester")
    tester = TESTERS.build(dict(type=tester_cfg["type"], cfg=cfg))
    tester.test()
    return tester


def main():
    args = default_argument_parser().parse_args()
    cfg = default_config_parser(args.config_file, args.options)
    main_worker(cfg)


if __name__ == "__main__":
    main()
