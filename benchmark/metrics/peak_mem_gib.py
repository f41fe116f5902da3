"""torch.cuda.max_memory_allocated() from the tester's build to the window's end, in GiB: the program's own, the benchmark's weights taken off the card before."""

UNIT = "GiB"


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
