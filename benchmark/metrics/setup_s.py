"""Set-up seconds: process start to the window's start (imports, scene files, the tester's build and its checkpoint's load, the kernels' build and warm-up), less the benchmark's own work (the seeded weights, their calibration by the reference, the checkpoint written)."""

UNIT = "s"


def read(run):
    return run.setup_s or None
