"""The test cell's inputs, worked out again on the benchmark's side from
the scene arrays the benchmark wrote: the recipe's test-time pipeline
(``CenterShift`` with z, ``NormalizeColor``; each rotation of
``aug_transform``; ``GridSample(mode="test")``; per fragment
``CenterShift`` without z and ``Collect``'s features), after the
semantics of the published transforms. It imports nothing of the program.

The test voxelisation's fragment k takes the (k mod c)-th point of each
voxel of c points, in an order the recipe leaves to its sort. So the
check does not pick a fragment's points itself: it holds the program's
fragments to what any such order gives. Each row is a point of its own
voxel, one row a voxel and every voxel a row; a rotation has as many
fragments as its fullest voxel has points, and they cover every point;
each row's features are those of its point. The reference then runs on
the rows and features worked out here for the points the program chose.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

# features may differ by the rounding of an f32 pipeline, not more
FEAT_RTOL = FEAT_ATOL = 1e-5


class Rotation(NamedTuple):
    coord: np.ndarray  # (N, 3) f64, the rotated points
    normal: np.ndarray  # (N, 3) f64
    grid: np.ndarray  # (N, 3) int64, each point's voxel
    voxels: int  # occupied voxels
    fragments: int  # points of the fullest voxel


class Scene(NamedTuple):
    color: np.ndarray  # (N, 3) normalised
    rotations: List[Rotation]


class Pipeline(NamedTuple):
    grid_size: float
    angles: Tuple[float, ...]  # each rotation about z, in units of pi

    @classmethod
    def from_config(cls, test: Dict) -> "Pipeline":
        """The parameters of a ``data.test`` entry, which must hold the
        pipeline this module works out and nothing else."""
        tc = test["test_cfg"]
        types = [t["type"] for t in test["transform"]]
        vox = tc["voxelize"]
        post = tc["post_transform"]
        ok = (types == ["CenterShift", "NormalizeColor"]
              and test["transform"][0].get("apply_z", True)
              and vox["type"] == "GridSample" and vox["mode"] == "test"
              and not tc.get("crop")
              and [t["type"] for t in post] == ["CenterShift", "Collect"]
              and not post[0].get("apply_z", True)
              and tuple(post[1].get("feat_keys", ())) == ("color", "normal", "coord"))
        angles = []
        for aug in tc["aug_transform"]:
            (t,) = aug
            ok = ok and (t["type"] == "RandomRotateTargetAngle" and len(t["angle"]) == 1
                         and t["axis"] == "z" and list(t["center"]) == [0, 0, 0]
                         and t["p"] >= 1)
            angles.append(float(t["angle"][0]))
        if not ok:
            raise ValueError("the test pipeline is not the one benchmark/reference/"
                             "fragments.py works out")
        return cls(float(vox["grid_size"]), tuple(angles))

    def scene(self, s: Dict[str, np.ndarray]) -> Scene:
        """Every rotation of one scene (``coord``, ``color``, ``normal``
        as written), before its fragments are drawn."""
        coord = np.asarray(s["coord"], np.float32)
        lo, hi = coord.min(0), coord.max(0)
        coord = coord - [(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, lo[2]]
        color = np.asarray(s["color"], np.float32) / 127.5 - 1.0
        normal = np.asarray(s["normal"], np.float32)
        rotations = []
        for a in self.angles:
            c, si = np.cos(a * np.pi), np.sin(a * np.pi)
            rot = np.array([[c, -si, 0], [si, c, 0], [0, 0, 1]])
            xyz = coord.astype(np.float64) @ rot.T
            grid = np.floor(xyz / self.grid_size).astype(np.int64)
            grid -= grid.min(0)
            _, counts = np.unique(voxel_key(grid), return_counts=True)
            rotations.append(Rotation(xyz, normal.astype(np.float64) @ rot.T, grid,
                                      len(counts), int(counts.max())))
        return Scene(color, rotations)

    def first_fragment(self, s: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The unrotated scene's fragment of each voxel's first point, in
        the keys the recipe's ``Collect`` gives a fragment."""
        scene = self.scene(s)
        rot = scene.rotations[0]
        _, index = np.unique(voxel_key(rot.grid), return_index=True)
        grid, feat = inputs(scene.color, rot, index)
        return dict(coord=rot.coord[index], grid_coord=grid, index=index,
                    offset=np.array([len(index)]), feat=feat)


def voxel_key(grid: np.ndarray) -> np.ndarray:
    """(N, 3) non-negative voxel coordinates under 2**20 -> (N,) int64."""
    return (grid[:, 0] << 40) | (grid[:, 1] << 20) | grid[:, 2]


def inputs(color: np.ndarray, rot: Rotation, index: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """The voxels and the f32 features (colour, normal, the fragment's
    points centred in x and y) of the points ``index`` of one fragment."""
    xyz = rot.coord[index]
    lo, hi = xyz.min(0), xyz.max(0)
    xyz = xyz - [(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, 0]
    feat = np.concatenate([color[index], rot.normal[index], xyz], 1).astype(np.float32)
    return rot.grid[index], feat


class Fragment(NamedTuple):
    """A fragment as the program handed it to its model: its valid rows'
    batch id, voxel, features and point index."""

    batch: np.ndarray
    grid: np.ndarray
    feat: np.ndarray
    index: np.ndarray


def mismatch(scene: Scene, rotation: int, frag: Fragment
             ) -> Tuple[int, Tuple[np.ndarray, np.ndarray]]:
    """Rows of one program fragment that the recipe's voxelisation does
    not give (a row off its point's voxel or features, in another scene of
    the batch, on a voxel twice, and each voxel with no row), and the
    recipe's voxels and features of the fragment's points (None where an
    index lies outside the scene)."""
    if rotation >= len(scene.rotations):
        return len(frag.index), None
    rot = scene.rotations[rotation]
    index = np.asarray(frag.index, np.int64)
    if len(index) == 0 or index.min() < 0 or index.max() >= len(rot.grid):
        return len(index) + rot.voxels, None
    grid, feat = inputs(scene.color, rot, index)
    bad = ((np.asarray(frag.grid) != grid).any(1) | (np.asarray(frag.batch) != 0)
           | ~np.isclose(frag.feat, feat, rtol=FEAT_RTOL, atol=FEAT_ATOL).all(1))
    held = len(np.unique(voxel_key(grid)))
    return int(bad.sum()) + (len(index) - held) + (rot.voxels - held), (grid, feat)


def rotation_of(scene: Scene, k: int) -> int:
    """The rotation of a scene's k-th fragment, the rotations' fragments
    in the order of ``aug_transform``."""
    for r, rot in enumerate(scene.rotations):
        if k < rot.fragments:
            return r
        k -= rot.fragments
    return len(scene.rotations)


def coverage_mismatch(scene: Scene, indices: Sequence[np.ndarray]) -> int:
    """For a scene voted to the end from the fragments' ``indices``: the
    fragments more or fewer than the rotations' fullest voxels ask, and
    each rotation's points that none of its fragments holds."""
    want = sum(r.fragments for r in scene.rotations)
    bad = abs(len(indices) - want)
    at = 0
    for rot in scene.rotations:
        held = np.zeros(len(rot.grid), bool)
        for index in indices[at:at + rot.fragments]:
            index = np.asarray(index, np.int64)
            held[index[(index >= 0) & (index < len(held))]] = True
        bad += int((~held).sum())
        at += rot.fragments
    return bad
