"""Plain PyTorch SpUNet-v1m1 segmentor: forward, CE + Lovasz loss and
its gradients.

The yardstick the benchmark holds the program to. It imports nothing of
the program: the rulebooks come from the voxel coordinates by a sorted-key
lookup, every conv is a gather, a matmul per tap and a scatter (with its
own backward, so that no per-tap gather is kept for autograd), and every
norm is a batch norm over the level's rows. Module and parameter names are
the reference PonderV2 ones (``conv_input.0.weight``, ``enc.{s}.block{b}.*``,
``up.{ref}.*``, ``dec.{ref}.*``, ``final.*``), so one state dict serves
both sides.

Semantics (spconv, as the paper's code runs them):
- a submanifold k^3 conv: output row i sums, for each tap (a, b, c) in
  ``itertools.product(range(k), repeat=3)``, ``W[a, b, c] @ x[j]`` with j
  the row at voxel ``v_i + (a, b, c) - k // 2``; where two rows share that
  voxel (Mix3D), the lowest row answers;
- the 2x2x2 stride-2 down conv: input row i adds ``W[v_i mod 2] @ x[i]``
  into the voxel ``floor(v_i / 2)``;
- the inverse conv: fine row i takes ``W[v_i mod 2] @ y[parent(i)]``.

``precision="tf32"`` rounds every matmul operand to TF32 (10 mantissa
bits, to nearest even) and sums in f32, as the tensor cores' TF32 mode
does: the control, one step below the configuration's f32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..counts.sparse import coord_key

BN_EPS = 1e-3


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (ties to even), kept in f32; the
    gradient passes through unchanged."""
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    rounded = i.view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return tf32_round(a) @ tf32_round(b)
        return a @ b


@contextlib.contextmanager
def f32_products():
    """f32 products stay f32 inside (TF32 is only ever the emulated
    control); the process's settings are restored on the way out."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Rule(NamedTuple):
    """Per tap, the live (input row, output row) pairs of one conv."""

    pairs: List[Tuple[torch.Tensor, torch.Tensor]]
    n_out: int


class _GatherConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, rule: Rule, prec: Precision):
        ctx.save_for_backward(x, w)
        ctx.rule, ctx.prec = rule, prec
        out = x.new_zeros(rule.n_out, w.shape[2])
        for t, (i, o) in enumerate(rule.pairs):
            if i.numel():
                out.index_add_(0, o, prec.mm(x[i], w[t]))
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        rule, prec = ctx.rule, ctx.prec
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        dw = torch.zeros_like(w)
        for t, (i, o) in enumerate(rule.pairs):
            if not i.numel():
                continue
            go = g[o]
            if dx is not None:
                dx.index_add_(0, i, prec.mm(go, w[t].t()))
            dw[t] = prec.mm(x[i].t(), go)
        return dx, dw, None, None


def conv(x: torch.Tensor, w: torch.Tensor, rule: Rule, prec: Precision) -> torch.Tensor:
    """``w`` as (k, k, k, Cin, Cout) or (K^3, Cin, Cout)."""
    return _GatherConv.apply(x, w.reshape(-1, w.shape[-2], w.shape[-1]), rule, prec)


class Level(NamedTuple):
    coords: torch.Tensor  # (N, 4) int64 rows
    parent: Optional[torch.Tensor]  # (N,) row of the next level's voxel
    tap: Optional[torch.Tensor]  # (N,) 2x2x2 tap into that voxel


def build_levels(coords: torch.Tensor, num_levels: int) -> List[Level]:
    out, c = [], coords.to(torch.int64)
    for lvl in range(num_levels):
        if lvl == num_levels - 1:
            out.append(Level(c, None, None))
            break
        half = torch.div(c[:, 1:], 2, rounding_mode="floor")
        down = torch.cat([c[:, :1], half], 1)
        nxt, parent = torch.unique(down, dim=0, return_inverse=True)
        r = c[:, 1:] - 2 * half
        out.append(Level(c, parent, r[:, 0] * 4 + r[:, 1] * 2 + r[:, 2]))
        c = nxt
    return out


def subm_rule(coords: torch.Tensor, kernel: int) -> Rule:
    keys = coord_key(coords)
    sorted_keys, order = torch.sort(keys, stable=True)  # lowest row first
    rows = torch.arange(coords.shape[0], device=coords.device)
    pad = kernel // 2
    pairs = []
    for off in itertools.product(range(kernel), repeat=3):
        q = coords.clone()
        q[:, 1:] += torch.tensor(off, device=q.device) - pad
        qk = coord_key(q)
        pos = torch.searchsorted(sorted_keys, qk).clamp(max=keys.shape[0] - 1)
        hit = sorted_keys[pos] == qk
        pairs.append((order[pos[hit]], rows[hit]))
    return Rule(pairs, coords.shape[0])


def down_rule(level: Level, n_out: int) -> Rule:
    rows = torch.arange(level.coords.shape[0], device=level.coords.device)
    pairs = [(rows[level.tap == t], level.parent[level.tap == t]) for t in range(8)]
    return Rule(pairs, n_out)


def up_rule(level: Level) -> Rule:
    rows = torch.arange(level.coords.shape[0], device=level.coords.device)
    pairs = [(level.parent[level.tap == t], rows[level.tap == t]) for t in range(8)]
    return Rule(pairs, level.coords.shape[0])


class Plans(NamedTuple):
    stem: Rule
    subm: List[Rule]  # k3 rule per level
    down: List[Rule]  # level s -> s + 1
    up: List[Rule]  # level s + 1 -> s


def build_plans(coords: torch.Tensor, num_stages: int = 4) -> Plans:
    lv = build_levels(coords, num_stages + 1)
    return Plans(subm_rule(lv[0].coords, 5),
                 [subm_rule(v.coords, 3) for v in lv],
                 [down_rule(lv[s], lv[s + 1].coords.shape[0]) for s in range(num_stages)],
                 [up_rule(lv[s]) for s in range(num_stages)])


# ----------------------------------------------------------------- model
class Arch(NamedTuple):
    in_channels: int
    base: int
    channels: Tuple[int, ...]
    layers: Tuple[int, ...]
    num_classes: int

    @property
    def stages(self) -> int:
        return len(self.layers) // 2


def arch_from_config(backbone: Dict) -> Arch:
    if backbone.get("type") not in ("SpUNet-v1m1", "SpUNet-v1m2"):
        raise ValueError(f"no plain reference for {backbone.get('type')}")
    return Arch(backbone.get("in_channels", 6), backbone.get("base_channels", 32),
                tuple(backbone.get("channels", (32, 64, 128, 256, 256, 128, 96, 96))),
                tuple(backbone.get("layers", (2, 3, 4, 6, 2, 2, 2, 2))),
                backbone.get("num_classes", 20))


def _bn_names(prefix: str) -> List[Tuple[str, str]]:
    return [(f"{prefix}.weight", "one"), (f"{prefix}.bias", "zero"),
            (f"{prefix}.running_mean", "zero"), (f"{prefix}.running_var", "one")]


def param_specs(arch: Arch) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every entry of the segmentor's state dict,
    ``backbone.``-prefixed. ``init``: ``conv`` uniform within
    sqrt(1 / fan_in), ``normal`` N(0, 1 / fan_in), ``one``, ``zero``."""
    specs = []

    def conv_w(name, k, cin, cout):
        specs.append((name, (k, k, k, cin, cout), "conv"))

    def bn(prefix, c):
        specs.extend((n, (c,), init) for n, init in _bn_names(prefix))

    def block(prefix, cin, c):
        conv_w(f"{prefix}.conv1.weight", 3, cin, c)
        bn(f"{prefix}.bn1", c)
        conv_w(f"{prefix}.conv2.weight", 3, c, c)
        bn(f"{prefix}.bn2", c)
        if cin != c:
            specs.append((f"{prefix}.proj.0.weight", (1, 1, 1, cin, c), "normal"))
            bn(f"{prefix}.proj.1", c)

    a = arch
    conv_w("conv_input.0.weight", 5, a.in_channels, a.base)
    bn("conv_input.1", a.base)
    enc, prev = [a.base], a.base
    for s in range(a.stages):
        conv_w(f"down.{s}.0.weight", 2, prev, a.channels[s])
        bn(f"down.{s}.1", a.channels[s])
        for b in range(a.layers[s]):
            block(f"enc.{s}.block{b}", a.channels[s], a.channels[s])
        prev = a.channels[s]
        enc.append(prev)
    ups, decs = {}, {}
    for s in range(a.stages):
        ref = a.stages - 1 - s
        dec = a.channels[a.stages + s]
        ups[ref] = (prev, dec)
        decs[ref] = [(dec + enc[ref] if b == 0 else dec, dec)
                     for b in range(a.layers[a.stages + s])]
        prev = dec
    for ref in range(a.stages):  # the reference builds up/dec ascending
        conv_w(f"up.{ref}.0.weight", 2, *ups[ref])
        bn(f"up.{ref}.1", ups[ref][1])
        for b, (cin, c) in enumerate(decs[ref]):
            block(f"dec.{ref}.block{b}", cin, c)
    specs.append(("final.weight", (a.num_classes, prev), "normal"))
    specs.append(("final.bias", (a.num_classes,), "zero"))
    return [("backbone." + n, shape, init) for n, shape, init in specs]


def trainable(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


class Norms:
    """Batch norm over the level's rows: in training the batch's mean and
    biased variance (and, with ``calibrate``, the running statistics set
    to them, the variance unbiased); in evaluation the running ones."""

    def __init__(self, params: Dict[str, torch.Tensor], train: bool,
                 calibrate: bool = False):
        self.p, self.train, self.calibrate = params, train, calibrate

    def __call__(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        p = self.p
        if self.train:
            var, mean = torch.var_mean(x, 0, unbiased=False)
            if self.calibrate:
                with torch.no_grad():
                    n = x.shape[0]
                    p[f"{prefix}.running_mean"].copy_(mean)
                    p[f"{prefix}.running_var"].copy_(var * n / max(n - 1, 1))
        else:
            mean, var = p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"]
        y = (x - mean) / torch.sqrt(var + BN_EPS)
        return y * p[f"{prefix}.weight"] + p[f"{prefix}.bias"]


def forward(arch: Arch, params: Dict[str, torch.Tensor], feat: torch.Tensor,
            plans: Plans, train: bool, prec: Precision,
            calibrate: bool = False) -> torch.Tensor:
    """Logits (N, num_classes) of the level-0 rows. ``params`` keyed by
    ``param_specs`` names (with the ``backbone.`` prefix)."""
    p = {k[len("backbone."):]: v for k, v in params.items()}
    bn = Norms(p, train, calibrate)
    relu = torch.relu

    def block(x, rule, prefix):
        h = relu(bn(conv(x, p[f"{prefix}.conv1.weight"], rule, prec), f"{prefix}.bn1"))
        h = bn(conv(h, p[f"{prefix}.conv2.weight"], rule, prec), f"{prefix}.bn2")
        identity = x
        if f"{prefix}.proj.0.weight" in p:
            w = p[f"{prefix}.proj.0.weight"]
            identity = bn(prec.mm(x, w.reshape(w.shape[-2], w.shape[-1])),
                          f"{prefix}.proj.1")
        return relu(h + identity)

    x = relu(bn(conv(feat, p["conv_input.0.weight"], plans.stem, prec), "conv_input.1"))
    skips = [x]
    for s in range(arch.stages):
        x = relu(bn(conv(x, p[f"down.{s}.0.weight"], plans.down[s], prec), f"down.{s}.1"))
        for b in range(arch.layers[s]):
            x = block(x, plans.subm[s + 1], f"enc.{s}.block{b}")
        skips.append(x)
    for s in range(arch.stages):
        ref = arch.stages - 1 - s
        x = relu(bn(conv(x, p[f"up.{ref}.0.weight"], plans.up[ref], prec), f"up.{ref}.1"))
        x = torch.cat([x, skips[ref]], 1)
        for b in range(arch.layers[arch.stages + s]):
            x = block(x, plans.subm[ref], f"dec.{ref}.block{b}")
    return prec.mm(x, p["final.weight"].t()) + p["final.bias"]


# ------------------------------------------------------------------ loss
def cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean over the rows whose label is not -1."""
    keep = target >= 0
    return torch.nn.functional.cross_entropy(logits[keep], target[keep])


def lovasz_softmax(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Berman et al. (CVPR 2018), multiclass, over the whole batch, the mean
    over the classes present in ``target`` (rows labelled -1 left out)."""
    keep = target >= 0
    probs = torch.softmax(logits[keep], -1)
    t = target[keep]
    losses = []
    for c in range(logits.shape[1]):
        fg = (t == c).to(probs.dtype)
        if not bool(fg.any()):
            continue
        errors = (fg - probs[:, c]).abs()
        errors_sorted, perm = torch.sort(errors, descending=True)
        fg_sorted = fg[perm]
        gts = fg_sorted.sum()
        inter = gts - fg_sorted.cumsum(0)
        union = gts + (1.0 - fg_sorted).cumsum(0)
        jac = 1.0 - inter / union
        jac = torch.cat([jac[:1], jac[1:] - jac[:-1]])
        losses.append(torch.dot(errors_sorted, jac))
    return torch.stack(losses).mean()


def seg_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The recipe's criteria: cross entropy + Lovasz, each of weight 1."""
    return cross_entropy(logits, target) + lovasz_softmax(logits, target)


@torch.no_grad()
def eval_logits(arch: Arch, params: Dict[str, torch.Tensor], coords: torch.Tensor,
                feat: torch.Tensor, prec: Precision) -> torch.Tensor:
    with f32_products():
        return forward(arch, params, feat, build_plans(coords), False, prec)


@torch.no_grad()
def calibrate_norms(arch: Arch, params: Dict[str, torch.Tensor], coords: torch.Tensor,
                    feat: torch.Tensor) -> None:
    """Set every norm's running statistics to its batch statistics over one
    input, so that activations keep their scale through the layers."""
    with f32_products():
        forward(arch, params, feat, build_plans(coords), True, Precision(), calibrate=True)
