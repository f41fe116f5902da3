"""Host ms per window fragment in the test dataset's __getitem__ (load, transforms, test voxelisation) and the tester's collate_fn."""

from benchmark.harness import readers

UNIT = "ms"
LAYER = "data"
MOVES = "test_fragments_per_s"


def read(run):
    return readers.per_unit_ms(run, "scene_prep", "collate")
