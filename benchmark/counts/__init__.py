"""The yardstick's arithmetic: published H100 peaks and the least time a
piece of work can take on the card.

The peaks and ``bound_s`` are a frozen copy of ``chip_smoke.py``'s
``HBM_BYTES_S``, ``PEAK_FLOPS`` and ``bound_ms`` (seconds here, not ms).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: HBM bytes/s;
# FLOP/s of bf16 / fp16 on the tensor cores, and of f32 at f32 accuracy,
# 3xTF32 (three TF32 products per f32 product, as the port's f32 tiles
# run) at a third of the 495 TFLOP/s TF32 rate
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12 / 3}


def dtype_name(dtype) -> str:
    """``torch.float32`` or ``"float32"`` -> ``"float32"``."""
    return str(dtype).rsplit(".", 1)[-1]


def flop_seconds(flops: float, dtype) -> float:
    """Seconds ``flops`` take at the peak of ``dtype``."""
    return flops / PEAK_FLOPS[dtype_name(dtype)]


def bound_s(moved_bytes: float, flops: float, dtype) -> float:
    """The least time an H100 SXM could take: max(bytes / 3.35 TB/s,
    FLOPs / the peak of the dtype), in seconds."""
    return max(moved_bytes / HBM_BYTES_S, flop_seconds(flops, dtype))
