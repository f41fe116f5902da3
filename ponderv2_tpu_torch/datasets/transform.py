"""Data transform pipeline (numpy, host-side): the slice's subset.

A copy of the transforms that the ScanNet test path runs, taken from
``ponderv2_tpu/datasets/transform.py`` with only the import lines changed:
the JAX package cannot be imported without JAX (its ``utils`` package
imports ``optax``). Goes away once that package imports lazily.
"""

from __future__ import annotations

import numpy as np

from ..utils.registry import Registry

TRANSFORMS = Registry("transforms")


@TRANSFORMS.register_module()
class Compose:
    def __init__(self, cfg=None):
        self.cfg = cfg if cfg is not None else []
        self.transforms = [TRANSFORMS.build(t) for t in self.cfg]

    def __call__(self, data_dict):
        for t in self.transforms:
            data_dict = t(data_dict)
        return data_dict


@TRANSFORMS.register_module()
class Collect:
    def __init__(self, keys, offset_keys_dict=None, **kwargs):
        """Gather ``keys``; create offset entries; ``feat_keys=(...)`` style kwargs
        concatenate listed arrays channel-wise into a new key (reference
        transform.py:27-52)."""
        if offset_keys_dict is None:
            offset_keys_dict = dict(offset="coord")
        self.keys = [keys] if isinstance(keys, str) else list(keys)
        self.offset_keys = offset_keys_dict
        self.kwargs = kwargs

    def __call__(self, data_dict):
        out = {}
        for k in self.keys:
            out[k] = data_dict[k]
        for new_key, src in self.offset_keys.items():
            out[new_key] = np.array([data_dict[src].shape[0]])
        for name, keys in self.kwargs.items():
            assert name.endswith("_keys")
            out[name[: -len("_keys")]] = np.concatenate(
                [data_dict[k].reshape(data_dict[k].shape[0], -1) for k in keys],
                axis=1,
            ).astype(np.float32)
        return out


# ------------------------------------------------------------------ geometric


def _update_cameras(data_dict, keys, point_mat4):
    """Right-multiply listed camera matrices by the inverse point transform.

    If points are transformed as p' = T p, a camera matrix M (world→cam/pixel)
    stays consistent by M' = M @ T^-1.
    """
    if not keys:
        return
    inv = np.linalg.inv(point_mat4)
    for key in keys:
        if key not in data_dict:
            continue
        mats = data_dict[key]
        data_dict[key] = (np.asarray(mats) @ inv).astype(np.float32)


def _mat4_linear(lin, center=None):
    """Embed a 3x3 linear map (about optional center) as a 4x4 homogeneous mat."""
    m = np.eye(4)
    m[:3, :3] = lin
    if center is not None:
        m[:3, 3] = center - lin @ center
    return m


def _mat4_translate(t):
    m = np.eye(4)
    m[:3, 3] = t
    return m


@TRANSFORMS.register_module()
class CenterShift:
    def __init__(self, apply_z=True, keys=None):
        self.apply_z = apply_z
        self.keys = keys

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        x_min, y_min, z_min = coord.min(axis=0)
        x_max, y_max, _ = coord.max(axis=0)
        shift = [(x_min + x_max) / 2, (y_min + y_max) / 2, z_min if self.apply_z else 0]
        data_dict["coord"] = coord - shift
        _update_cameras(data_dict, self.keys, _mat4_translate(-np.asarray(shift)))
        return data_dict


@TRANSFORMS.register_module()
class PositiveShift:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, data_dict):
        mins = data_dict["coord"].min(axis=0)
        data_dict["coord"] = data_dict["coord"] - mins
        _update_cameras(data_dict, self.keys, _mat4_translate(-mins))
        return data_dict


@TRANSFORMS.register_module()
class RandomRotate:
    def __init__(self, angle=None, center=None, axis="z", always_apply=False,
                 p=0.5, keys=None):
        self.angle = [-1, 1] if angle is None else angle
        self.axis = axis
        self.center = center
        self.p = 1.0 if always_apply else p
        self.keys = keys

    def __call__(self, data_dict):
        if np.random.rand() > self.p:
            return data_dict
        angle = np.random.uniform(self.angle[0], self.angle[1]) * np.pi
        c, s = np.cos(angle), np.sin(angle)
        if self.axis == "x":
            rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        elif self.axis == "y":
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        else:
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        coord = data_dict["coord"]
        if self.center is None:
            lo, hi = coord.min(0), coord.max(0)
            center = (lo + hi) / 2
        else:
            center = np.asarray(self.center)
        data_dict["coord"] = (coord - center) @ rot.T + center
        if "normal" in data_dict:
            data_dict["normal"] = data_dict["normal"] @ rot.T
        _update_cameras(data_dict, self.keys, _mat4_linear(rot, center))
        return data_dict


@TRANSFORMS.register_module()
class RandomRotateTargetAngle(RandomRotate):
    def __init__(self, angle=(1 / 2, 1, 3 / 2), center=None, axis="z",
                 always_apply=False, p=0.75, keys=None):
        super().__init__(angle=angle, center=center, axis=axis,
                         always_apply=always_apply, p=p, keys=keys)

    def __call__(self, data_dict):
        if np.random.rand() > self.p:
            return data_dict
        angle = float(np.random.choice(self.angle)) * np.pi
        # stateless fixed-angle rotation (no self-mutation: dataloader-safe)
        fixed = RandomRotate(angle=[angle / np.pi, angle / np.pi],
                             center=self.center, axis=self.axis, p=1.0,
                             keys=self.keys)
        return fixed(data_dict)


# ----------------------------------------------------------------- photometric


@TRANSFORMS.register_module()
class NormalizeColor:
    """[0,255] -> [-1,1] (reference transform.py:114-121)."""

    def __call__(self, data_dict):
        if "color" in data_dict:
            data_dict["color"] = data_dict["color"] / 127.5 - 1.0
        return data_dict


# -------------------------------------------------------------------- sampling


def _index_points(data_dict, idx):
    n = len(data_dict["coord"])
    for k, v in data_dict.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
            data_dict[k] = v[idx]
    return data_dict



@TRANSFORMS.register_module()
class GridSample:
    """Voxel-grid subsampling (the reference's central sampling transform,
    transform.py:1078-1213).

    mode="train": one random point per voxel (hash_type picks ravel or FNV ids);
    mode="test": emits ``count.max()`` complementary fragments covering every
    point, each a dict suffixed into a list (fragment voting at test time).
    """

    def __init__(self, grid_size=0.05, hash_type="fnv", mode="train",
                 keys=("coord", "color", "normal", "segment"),
                 return_inverse=False, return_grid_coord=False,
                 return_min_coord=False, return_displacement=False,
                 project_displacement=False):
        self.grid_size = grid_size
        self.hash = self._fnv_hash_vec if hash_type == "fnv" else self._ravel_hash_vec
        assert mode in ("train", "test")
        self.mode = mode
        self.keys = keys
        self.return_inverse = return_inverse
        self.return_grid_coord = return_grid_coord
        self.return_min_coord = return_min_coord
        self.return_displacement = return_displacement
        self.project_displacement = project_displacement

    def _voxel_runs(self, grid_coord):
        """Group points into voxel runs: returns ``(order, starts, counts,
        point_voxel)`` where ``order`` sorts points by voxel id, run ``v``
        occupies ``order[starts[v] : starts[v] + counts[v]]``, and
        ``point_voxel[p]`` is point ``p``'s voxel run id."""
        ids = self.hash(grid_coord)
        order = np.argsort(ids)
        _, run_of_sorted, counts = np.unique(
            ids[order], return_inverse=True, return_counts=True
        )
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        point_voxel = np.empty_like(run_of_sorted)
        point_voxel[order] = run_of_sorted
        return order, starts, counts, point_voxel

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        scaled = coord / np.array(self.grid_size)
        grid_coord = np.floor(scaled).astype(int)
        origin = grid_coord.min(0)
        grid_coord -= origin
        scaled -= origin
        min_coord = origin * np.array(self.grid_size)
        order, starts, counts, point_voxel = self._voxel_runs(grid_coord)

        if self.mode == "train":
            # one random survivor per voxel run (a single randint batch, taken
            # mod each run's length — matches the reference's sampling law)
            draw = np.random.randint(0, counts.max(), counts.size) % counts
            keep = order[starts + draw]
            if "sampled_index" in data_dict:
                # forced keep for points referenced downstream (e.g. sparse depth)
                anchor = np.unique(data_dict["sampled_index"])
                keep = np.unique(np.append(keep, anchor))
                anchored = np.zeros(coord.shape[0], dtype=bool)
                anchored[data_dict["sampled_index"]] = True
            out = _index_points(dict(data_dict), keep)
            if "sampled_index" in data_dict:
                out["sampled_index"] = np.where(anchored[keep])[0]
            if self.return_inverse:
                out["inverse"] = point_voxel
            if self.return_grid_coord:
                out["grid_coord"] = grid_coord[keep]
            if self.return_min_coord:
                out["min_coord"] = min_coord.reshape(1, 3)
            if self.return_displacement:
                disp = scaled - grid_coord - 0.5
                if self.project_displacement:
                    disp = np.sum(disp * data_dict["normal"], axis=-1, keepdims=True)
                out["displacement"] = disp[keep]
            return out

        # test mode: count.max() complementary fragments — fragment i takes
        # the (i mod len)-th point of every voxel run, so the fragments
        # jointly cover every point (reference transform.py:1147-1175)
        fragments = []
        for i in range(counts.max()):
            part_idx = order[starts + i % counts]
            part = dict(index=part_idx)
            for key_name in data_dict.keys():
                if key_name in self.keys:
                    part[key_name] = data_dict[key_name][part_idx]
                else:
                    part[key_name] = data_dict[key_name]
            if self.return_inverse:
                part["inverse"] = point_voxel
            if self.return_grid_coord:
                part["grid_coord"] = grid_coord[part_idx]
            if self.return_min_coord:
                part["min_coord"] = min_coord.reshape(1, 3)
            fragments.append(part)
        data_dict["fragment_list"] = fragments
        return data_dict

    @staticmethod
    def _ravel_hash_vec(arr):
        assert arr.ndim == 2
        arr = arr.copy()
        arr -= arr.min(0)
        arr = arr.astype(np.uint64, copy=False)
        arr_max = arr.max(0).astype(np.uint64) + 1
        keys = np.zeros(arr.shape[0], dtype=np.uint64)
        for j in range(arr.shape[1] - 1):
            keys += arr[:, j]
            keys *= arr_max[j + 1]
        keys += arr[:, -1]
        return keys

    @staticmethod
    def _fnv_hash_vec(arr):
        assert arr.ndim == 2
        arr = arr.copy()
        arr = arr.astype(np.uint64, copy=False)
        hashed = np.uint64(14695981039346656037) * np.ones(
            arr.shape[0], dtype=np.uint64
        )
        for j in range(arr.shape[1]):
            hashed *= np.uint64(1099511628211)
            hashed = np.bitwise_xor(hashed, arr[:, j])
        return hashed
