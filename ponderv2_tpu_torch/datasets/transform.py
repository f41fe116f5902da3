"""Data transform pipeline (numpy, host-side).

A copy of the transforms of ``ponderv2_tpu/datasets/transform.py`` with only
the import lines changed: the JAX package cannot be imported without JAX
(its ``utils`` package imports ``optax``). Goes away once that package
imports lazily. Three pieces differ, each a fault of the JAX one (ROADMAP
Queue 3): ``RandomShift`` also reads a scalar per axis (F10); and, so that
labels can be projected onto the original points (F14), ``_index_points``
leaves the ``origin_*`` keys that ``Copy`` makes at their full length (as
the reference's ``index_operator`` leaves every key outside its list), and
``CenterShift`` moves ``origin_coord`` with ``coord``, so the two stay in
one frame.
"""

from __future__ import annotations

import copy

import numpy as np
import scipy.interpolate
import scipy.ndimage

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


@TRANSFORMS.register_module()
class Copy:
    def __init__(self, keys_dict=None):
        self.keys_dict = keys_dict or dict(coord="origin_coord", segment="origin_segment")

    def __call__(self, data_dict):
        for src, dst in self.keys_dict.items():
            if src in data_dict:
                data_dict[dst] = copy.deepcopy(data_dict[src])
        return data_dict


@TRANSFORMS.register_module()
class Add:
    def __init__(self, keys_dict=None):
        self.keys_dict = keys_dict or {}

    def __call__(self, data_dict):
        data_dict.update(copy.deepcopy(self.keys_dict))
        return data_dict


@TRANSFORMS.register_module()
class ToTensor:
    """No-op in the numpy pipeline (arrays go to device at collate); kept for
    config parity with the reference."""

    def __call__(self, data_dict):
        return data_dict


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
        if "origin_coord" in data_dict:  # F14: the original points in coord's frame
            data_dict["origin_coord"] = data_dict["origin_coord"] - shift
        _update_cameras(data_dict, self.keys, _mat4_translate(-np.asarray(shift)))
        return data_dict


@TRANSFORMS.register_module()
class RandomShift:
    """Translate the points by a uniform draw per axis (and the listed
    camera matrices with them). Each entry of ``shift`` is an axis's
    ``(lo, hi)`` range, or a scalar ``s`` for ``(-s, s)``: the nuScenes
    pretrain configs pass ``shift=[0.5, 0.5, 0.5]``, on which the JAX
    transform raises (``np.random.uniform(*0.5)``; ROADMAP Queue 3, F10).
    On pairs it draws exactly what the JAX transform draws."""

    def __init__(self, shift=((-0.2, 0.2), (-0.2, 0.2), (0, 0)), keys=None):
        self.shift = shift
        self.keys = keys

    def __call__(self, data_dict):
        s = np.array([np.random.uniform(*(r if np.ndim(r) else (-r, r)))
                      for r in self.shift])
        data_dict["coord"] = data_dict["coord"] + s
        _update_cameras(data_dict, self.keys, _mat4_translate(s))
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
class NormalizeCoord:
    """Center by centroid, scale by max radius (reference transform.py:124-149)."""

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        centroid = coord.mean(axis=0)
        coord = coord - centroid
        scale = np.max(np.sqrt(np.sum(coord**2, axis=1)))
        data_dict["coord"] = coord / max(scale, 1e-12)
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
    """Index every per-point array but the ``origin_*`` ones, which keep the
    original points whatever is sampled (F14: the JAX function subsamples
    them too, so a projection onto them is the identity)."""
    n = len(data_dict["coord"])
    for k, v in data_dict.items():
        if (isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n
                and not k.startswith("origin_")):
            data_dict[k] = v[idx]
    return data_dict


@TRANSFORMS.register_module()
class PointRangeFilter:
    """Drop points outside a fixed range (outdoor lidar)."""

    def __init__(self, point_cloud_range=(-54, -54, -5, 54, 54, 3), padding=0.1):
        self.range = np.asarray(point_cloud_range)
        self.padding = padding

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        keep = (
            (coord[:, 0] > self.range[0] + self.padding)
            & (coord[:, 0] < self.range[3] - self.padding)
            & (coord[:, 1] > self.range[1] + self.padding)
            & (coord[:, 1] < self.range[4] - self.padding)
            & (coord[:, 2] > self.range[2] + self.padding)
            & (coord[:, 2] < self.range[5] - self.padding)
        )
        return _index_points(data_dict, np.where(keep)[0])



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


# ------------------------------------------------- train-time augmentation


@TRANSFORMS.register_module()
class RandomScale:
    def __init__(self, scale=None, anisotropic=False, keys=None):
        self.scale = scale if scale is not None else [0.95, 1.05]
        self.anisotropic = anisotropic
        self.keys = keys

    def __call__(self, data_dict):
        s = np.random.uniform(
            self.scale[0], self.scale[1], 3 if self.anisotropic else 1
        )
        s = np.broadcast_to(s, (3,)).copy()
        data_dict["coord"] = data_dict["coord"] * s
        _update_cameras(data_dict, self.keys, _mat4_linear(np.diag(s)))
        return data_dict


@TRANSFORMS.register_module()
class RandomFlip:
    def __init__(self, p=0.5, keys=None):
        self.p = p
        self.keys = keys

    def __call__(self, data_dict):
        for axis in (0, 1):
            if np.random.rand() < self.p:
                sign = np.ones(3)
                sign[axis] = -1
                data_dict["coord"] = data_dict["coord"] * sign
                if "normal" in data_dict:
                    data_dict["normal"] = data_dict["normal"] * sign
                _update_cameras(data_dict, self.keys, _mat4_linear(np.diag(sign)))
        return data_dict


@TRANSFORMS.register_module()
class RandomJitter:
    def __init__(self, sigma=0.01, clip=0.05):
        self.sigma, self.clip = sigma, clip

    def __call__(self, data_dict):
        jitter = np.clip(
            self.sigma * np.random.randn(*data_dict["coord"].shape),
            -self.clip, self.clip,
        )
        data_dict["coord"] = data_dict["coord"] + jitter
        return data_dict


@TRANSFORMS.register_module()
class ClipGaussianJitter:
    def __init__(self, scalar=0.02):
        self.scalar = scalar
        self.quantile = 1.96

    def __call__(self, data_dict):
        noise = np.random.randn(*data_dict["coord"].shape)
        noise = np.clip(noise, -self.quantile, self.quantile) / self.quantile
        data_dict["coord"] = data_dict["coord"] + self.scalar * noise
        return data_dict


@TRANSFORMS.register_module()
class PointClip:
    def __init__(self, point_cloud_range=(-80, -80, -3, 80, 80, 1)):
        self.range = point_cloud_range

    def __call__(self, data_dict):
        data_dict["coord"] = np.clip(
            data_dict["coord"],
            a_min=self.range[:3], a_max=self.range[3:],
        )
        return data_dict


@TRANSFORMS.register_module()
class RandomDropout:
    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.5):
        self.ratio = dropout_ratio
        self.p = dropout_application_ratio

    def __call__(self, data_dict):
        if np.random.rand() < self.p:
            n = len(data_dict["coord"])
            idx = np.random.choice(n, int(n * (1 - self.ratio)), replace=False)
            data_dict = _index_points(data_dict, idx)
        return data_dict


@TRANSFORMS.register_module()
class ElasticDistortion:
    def __init__(self, distortion_params=None):
        self.params = (
            [[0.2, 0.4], [0.8, 1.6]] if distortion_params is None else distortion_params
        )

    @staticmethod
    def _distort(coords, granularity, magnitude):
        blurs = [np.ones((3, 1, 1, 1)) / 3, np.ones((1, 3, 1, 1)) / 3,
                 np.ones((1, 1, 3, 1)) / 3]
        mins = coords.min(0)
        dims = ((coords - mins).max(0) // granularity).astype(int) + 3
        noise = np.random.randn(*dims, 3).astype(np.float32)
        for _ in range(2):
            for blur in blurs:
                noise = scipy.ndimage.convolve(noise, blur, mode="constant", cval=0)
        ax = [np.linspace(d_min, d_max, d)
              for d_min, d_max, d in zip(mins - granularity,
                                         mins + granularity * (np.array(dims) - 2),
                                         dims)]
        interp = scipy.interpolate.RegularGridInterpolator(
            ax, noise, bounds_error=False, fill_value=0
        )
        return coords + interp(coords) * magnitude

    def __call__(self, data_dict):
        coord = data_dict["coord"].astype(np.float32)
        for granularity, magnitude in self.params:
            coord = self._distort(coord, granularity, magnitude)
        data_dict["coord"] = coord
        return data_dict


@TRANSFORMS.register_module()
class ChromaticAutoContrast:
    def __init__(self, p=0.2, blend_factor=None):
        self.p = p
        self.blend_factor = blend_factor

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            color = data_dict["color"]
            lo = color.min(0, keepdims=True)
            hi = color.max(0, keepdims=True)
            scale = 255 / np.maximum(hi - lo, 1e-12)
            contrast = (color - lo) * scale
            blend = self.blend_factor or np.random.rand()
            data_dict["color"] = (1 - blend) * color + blend * contrast
        return data_dict


@TRANSFORMS.register_module()
class ChromaticTranslation:
    def __init__(self, p=0.95, ratio=0.05):
        self.p, self.ratio = p, ratio

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            tr = (np.random.rand(1, 3) - 0.5) * 255 * 2 * self.ratio
            data_dict["color"] = np.clip(data_dict["color"] + tr, 0, 255)
        return data_dict


@TRANSFORMS.register_module()
class ChromaticJitter:
    def __init__(self, p=0.95, std=0.005):
        self.p, self.std = p, std

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            noise = np.random.randn(data_dict["color"].shape[0], 3) * self.std * 255
            data_dict["color"] = np.clip(data_dict["color"] + noise, 0, 255)
        return data_dict


@TRANSFORMS.register_module()
class RandomColorGrayScale:
    def __init__(self, p=0.1):
        self.p = p

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            gray = data_dict["color"] @ np.array([0.299, 0.587, 0.114])
            data_dict["color"] = np.stack([gray] * 3, axis=-1)
        return data_dict


@TRANSFORMS.register_module()
class RandomColorJitter:
    """Brightness/contrast/saturation/hue jitter on [0,255] colors."""

    def __init__(self, brightness=0.4, contrast=0.4, saturation=0.2, hue=0.02, p=0.95):
        self.brightness, self.contrast = brightness, contrast
        self.saturation, self.hue = saturation, hue
        self.p = p

    def __call__(self, data_dict):
        if "color" not in data_dict:
            return data_dict
        color = data_dict["color"].astype(np.float32)
        if np.random.rand() < self.p:
            color = color * np.random.uniform(1 - self.brightness, 1 + self.brightness)
        if np.random.rand() < self.p:
            mean = color.mean()
            color = (color - mean) * np.random.uniform(
                1 - self.contrast, 1 + self.contrast
            ) + mean
        if np.random.rand() < self.p:
            gray = (color @ np.array([0.299, 0.587, 0.114]))[:, None]
            color = (color - gray) * np.random.uniform(
                1 - self.saturation, 1 + self.saturation
            ) + gray
        data_dict["color"] = np.clip(color, 0, 255)
        return data_dict


@TRANSFORMS.register_module()
class RandomColorDrop:
    def __init__(self, p=0.2, color_augment=0.0):
        self.p, self.color_augment = p, color_augment

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            data_dict["color"] = data_dict["color"] * self.color_augment
        return data_dict


@TRANSFORMS.register_module()
class HueSaturationTranslation:
    def __init__(self, hue_max=0.5, saturation_max=0.2):
        self.hue_max, self.saturation_max = hue_max, saturation_max

    @staticmethod
    def _rgb_to_hsv(rgb):
        hsv = np.zeros_like(rgb)
        maxc = rgb.max(-1)
        minc = rgb.min(-1)
        v = maxc
        delta = maxc - minc
        s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0)
        dr = np.where(delta > 0, (rgb[..., 0] == maxc) * ((rgb[..., 1] - rgb[..., 2]) / np.maximum(delta, 1e-12)), 0)
        dg = np.where(delta > 0, (rgb[..., 1] == maxc) * (2.0 + (rgb[..., 2] - rgb[..., 0]) / np.maximum(delta, 1e-12)), 0)
        db = np.where(delta > 0, (rgb[..., 2] == maxc) * (4.0 + (rgb[..., 0] - rgb[..., 1]) / np.maximum(delta, 1e-12)), 0)
        h = (dr + dg + db) / 6.0 % 1.0
        hsv[..., 0], hsv[..., 1], hsv[..., 2] = h, s, v
        return hsv

    @staticmethod
    def _hsv_to_rgb(hsv):
        h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
        i = (h * 6).astype(int)
        f = h * 6 - i
        p = v * (1 - s)
        q = v * (1 - f * s)
        t = v * (1 - (1 - f) * s)
        i = i % 6
        out = np.zeros_like(hsv)
        lut = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
        for k, (r, g, b) in enumerate(lut):
            m = i == k
            out[..., 0][m], out[..., 1][m], out[..., 2][m] = r[m], g[m], b[m]
        return out

    def __call__(self, data_dict):
        if "color" not in data_dict:
            return data_dict
        hsv = self._rgb_to_hsv(data_dict["color"] / 255.0)
        hsv[..., 0] = (hsv[..., 0] + (np.random.rand() - 0.5) * 2 * self.hue_max) % 1.0
        hsv[..., 1] = np.clip(
            hsv[..., 1] + (np.random.rand() - 0.5) * 2 * self.saturation_max, 0, 1
        )
        data_dict["color"] = np.clip(self._hsv_to_rgb(hsv) * 255.0, 0, 255)
        return data_dict


@TRANSFORMS.register_module()
class SphereCrop:
    def __init__(self, point_max=80000, sample_rate=None, mode="random"):
        self.point_max = point_max
        self.sample_rate = sample_rate
        assert mode in ("random", "center", "all")
        self.mode = mode

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        point_max = (
            int(self.sample_rate * coord.shape[0])
            if self.sample_rate is not None
            else self.point_max
        )
        if self.mode == "all":
            return self._covering_crops(data_dict, point_max)
        if coord.shape[0] <= point_max:
            return data_dict
        if self.mode == "random":
            center = coord[np.random.randint(coord.shape[0])]
        else:
            center = coord[coord.shape[0] // 2]
        idx = np.argsort(np.sum((coord - center) ** 2, axis=1))[:point_max]
        return _index_points(data_dict, idx)

    def _covering_crops(self, data_dict, point_max):
        """Test-time covering crops (reference transform.py:1232-1281): emit a
        LIST of sphere crops until every point appears in at least one. Crop
        centers follow a potential field — each crop raises the potential of
        its points by (1 - d2/max d2)^2 and the next center is the
        lowest-potential point, pushing later crops toward uncovered regions.
        Each crop carries ``weight`` (its d2 to the center) and ``index``
        (original row ids) for vote merging."""
        coord = data_dict["coord"]
        n = coord.shape[0]
        if "index" not in data_dict:
            data_dict["index"] = np.arange(n)
        if n <= point_max:
            out = dict(data_dict)
            out["weight"] = np.zeros(n)
            return [out]
        crops = []
        potential = np.random.rand(n) * 1e-3
        covered = np.zeros(n, bool)
        while not covered.all():
            center = coord[np.argmin(potential)]
            d2 = np.sum((coord - center) ** 2, axis=1)
            idx_crop = np.argsort(d2)[:point_max]
            crop = _index_points(dict(data_dict), idx_crop)
            crop["weight"] = d2[idx_crop]
            crops.append(crop)
            potential[idx_crop] += np.square(1 - d2[idx_crop] / d2[idx_crop].max())
            covered[idx_crop] = True
        return crops


@TRANSFORMS.register_module()
class ShufflePoint:
    def __call__(self, data_dict):
        idx = np.random.permutation(len(data_dict["coord"]))
        return _index_points(data_dict, idx)


@TRANSFORMS.register_module()
class CropBoundary:
    def __call__(self, data_dict):
        segment = data_dict["segment"]
        keep = (segment != 0) & (segment != 1)
        return _index_points(data_dict, np.where(keep)[0])


@TRANSFORMS.register_module()
class InstanceParser:
    """Derive per-instance centroids/bboxes for instance-seg training
    (reference transform.py:1387-1431)."""

    def __init__(self, segment_ignore_index=(-1, 0, 1), instance_ignore_index=-1):
        self.segment_ignore_index = segment_ignore_index
        self.instance_ignore_index = instance_ignore_index

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        segment = data_dict["segment"]
        instance = data_dict["instance"].copy()
        mask = ~np.isin(segment, self.segment_ignore_index)
        instance[~mask] = self.instance_ignore_index
        # re-densify instance ids
        unique, inverse = np.unique(instance[mask], return_inverse=True)
        instance[mask] = inverse
        n_inst = len(unique)
        centroid = np.ones((coord.shape[0], 3)) * self.instance_ignore_index
        bbox = np.ones((max(n_inst, 1), 8)) * self.instance_ignore_index
        for i in range(n_inst):
            m = instance == i
            c = coord[m]
            centroid[m] = c.mean(0)
            cls = np.bincount(segment[m][segment[m] >= 0]).argmax() if (segment[m] >= 0).any() else -1
            bbox[i] = np.concatenate(
                [c.min(0), c.max(0), [cls], [m.sum()]]
            )
        data_dict["instance"] = instance
        data_dict["instance_centroid"] = centroid.astype(np.float32)
        data_dict["bbox"] = bbox.astype(np.float32)
        return data_dict


@TRANSFORMS.register_module()
class ContrastiveViewsGenerator:
    def __init__(self, view_keys=("coord", "color", "normal"),
                 view_trans_cfg=None):
        self.view_keys = view_keys
        self.view_trans = Compose(view_trans_cfg or [])

    def __call__(self, data_dict):
        for view in ("view1_", "view2_"):
            view_dict = {k: data_dict[k].copy() for k in self.view_keys}
            view_dict = self.view_trans(view_dict)
            for k, v in view_dict.items():
                data_dict[view + k] = v
        return data_dict


# ------------------------------------------------------------ outdoor pretrain


@TRANSFORMS.register_module()
class ProjectOnImage:
    """Project lidar points onto camera images; keep visible points with their
    pixel colors and view ids (reference transform.py:267-315, z-buffer overlap
    filter at 293-304)."""

    def __init__(self, depth_threshold=0.05, keys=("rgb",)):
        self.depth_threshold = depth_threshold
        self.keys = keys

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        l2i = data_dict["lidar2img"]  # (V, 4, 4)
        images = data_dict["rgb"]  # (V, H, W, 3)
        V = l2i.shape[0]
        n = coord.shape[0]
        hom = np.concatenate([coord, np.ones((n, 1))], axis=1)
        pix_color = np.zeros((n, 3), np.float32)
        view_id = np.full(n, -1, np.int64)
        pix_uv = np.zeros((n, 2), np.float32)
        for v in range(V):
            H, W = images[v].shape[:2]
            proj = hom @ l2i[v].T
            z = proj[:, 2]
            u = proj[:, 0] / np.maximum(z, 1e-6)
            w = proj[:, 1] / np.maximum(z, 1e-6)
            visible = (z > 0.1) & (u >= 0) & (u < W - 1) & (w >= 0) & (w < H - 1)
            visible &= view_id < 0  # first camera wins
            # z-buffer overlap filter: among points hitting the same pixel,
            # keep the nearest
            ui = np.round(u).astype(int)
            wi = np.round(w).astype(int)
            flat = wi * W + ui
            zbuf = np.full(H * W, np.inf, np.float32)
            vis_idx = np.where(visible)[0]
            order = vis_idx[np.argsort(z[vis_idx])]
            seen = np.zeros(H * W, bool)
            keep = []
            for i in order:
                f = flat[i]
                if not seen[f] or z[i] <= zbuf[f] + self.depth_threshold:
                    keep.append(i)
                    if not seen[f]:
                        zbuf[f] = z[i]
                        seen[f] = True
            keep = np.asarray(keep, int)
            view_id[keep] = v
            pix_color[keep] = images[v][wi[keep], ui[keep]]
            pix_uv[keep] = np.stack([u[keep], w[keep]], axis=1)
        data_dict["point_view_id"] = view_id
        data_dict["point_color"] = pix_color
        data_dict["point_uv"] = pix_uv
        return data_dict


@TRANSFORMS.register_module()
class RaySample:
    """Sample supervision rays camera-origin -> lidar point (reference
    transform.py:318-378): emits fixed-size ray_start/ray_end/ray_rgb (+labels)."""

    def __init__(self, point_nsample=512, point_ratio=None, fetch_color=True,
                 fetch_segment=True):
        self.point_nsample = point_nsample
        self.point_ratio = point_ratio
        self.fetch_color = fetch_color
        self.fetch_segment = fetch_segment

    def __call__(self, data_dict):
        view_id = data_dict["point_view_id"]
        coord = data_dict["coord"]
        l2c = data_dict["lidar2cam"]  # (V, 4, 4)
        cam_origin = np.stack(
            [np.linalg.inv(l2c[v])[:3, 3] for v in range(l2c.shape[0])]
        )
        candidates = np.where(view_id >= 0)[0]
        n = self.point_nsample
        if self.point_ratio is not None:
            n = min(n, max(int(len(candidates) * self.point_ratio), 1))
        if len(candidates) == 0:
            pick = np.zeros(n, int)
            valid = np.zeros(n, bool)
        else:
            pick = candidates[np.random.randint(0, len(candidates), n)]
            valid = np.ones(n, bool)
        data_dict["ray_start"] = cam_origin[np.maximum(view_id[pick], 0)].astype(np.float32)
        data_dict["ray_end"] = coord[pick].astype(np.float32)
        if self.fetch_color:  # reference fetch_color (transform.py:318-378)
            data_dict["ray_rgb"] = data_dict["point_color"][pick].astype(np.float32)
        if self.fetch_segment and "segment" in data_dict:
            seg = data_dict["segment"][pick]
            data_dict["ray_segment"] = np.where(valid, seg, -1).astype(np.int64)
        data_dict["ray_valid"] = valid
        # ray arrays are per-scene fixed-size: exclude from point-dim collation
        for k in ("point_view_id", "point_color", "point_uv"):
            data_dict.pop(k, None)
        return data_dict

