"""Work a sparse-voxel U-Net needs, counted from the voxel coordinates.

Nothing here reads the program's plans: the levels, the live rulebook
pairs and the operations follow from the input rows alone, by the conv
semantics of spconv (submanifold k^3 convs centred on each active voxel;
2x2x2 stride-2 down convs onto ``floor(v / 2)``; their inverse back onto
the fine rows).

A level-0 row is an input row: Mix3D can put two rows on one voxel, and
each row is then an output of its own that reads one of them, as the
program's rows do. Coarser levels hold one row per occupied voxel.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple, Sequence

import torch

from . import bound_s

# coordinates are shifted by SHIFT and packed COORD_BITS a value into one
# int64 key; scenes of the benchmark span at most a few hundred voxels
COORD_BITS = 12
SHIFT = 2


def coord_key(coords: torch.Tensor) -> torch.Tensor:
    """(N, 4) int (batch, x, y, z) -> (N,) int64 keys; exact for
    coordinates in [-SHIFT, 2**COORD_BITS - SHIFT)."""
    c = coords.to(torch.int64)
    key = c[:, 0]
    for a in range(1, 4):
        key = (key << COORD_BITS) + c[:, a] + SHIFT
    return key


def levels(rows: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """[level 0 rows (the input rows), level 1 voxels, ...]: each coarser
    level the occupied voxels of ``floor(v / 2)``, one row each."""
    out = [rows.to(torch.int64)]
    for _ in range(num_levels - 1):
        c = out[-1]
        down = torch.cat([c[:, :1], torch.div(c[:, 1:], 2, rounding_mode="floor")], 1)
        out.append(torch.unique(down, dim=0))
    return out


def neighbour_pairs(rows: torch.Tensor, kernel: int) -> int:
    """Live pairs of a submanifold conv of ``kernel``^3 over ``rows``: for
    every row and every tap, whether a row sits at the tap's voxel."""
    keys = torch.unique(coord_key(rows))
    pad = kernel // 2
    total = 0
    for off in itertools.product(range(-pad, pad + 1), repeat=3):
        q = rows.to(torch.int64).clone()
        q[:, 1:] += torch.tensor(off, dtype=torch.int64, device=q.device)
        k = coord_key(q)
        pos = torch.searchsorted(keys, k).clamp(max=keys.shape[0] - 1)
        total += int((keys[pos] == k).sum())
    return total


class Conv(NamedTuple):
    """One conv of the U-Net: ``kind`` is ``subm`` (k^3 at ``level``),
    ``down`` (level -> level + 1), ``up`` (level + 1 -> level) or ``dense``
    (a per-row matmul at ``level``: 1x1 shortcut or head); ``dx`` whether
    training takes its input gradient (not for the stem, whose input is
    the data)."""

    kind: str
    level: int
    kernel: int
    cin: int
    cout: int
    dx: bool = True


def spunet_convs(backbone: Dict) -> List[Conv]:
    """Every conv of SpUNet-v1m1 with the widths of its config."""
    in_c = backbone.get("in_channels", 6)
    base = backbone.get("base_channels", 32)
    ch = tuple(backbone.get("channels", (32, 64, 128, 256, 256, 128, 96, 96)))
    layers = tuple(backbone.get("layers", (2, 3, 4, 6, 2, 2, 2, 2)))
    classes = backbone.get("num_classes", 20)
    stages = len(layers) // 2
    convs = [Conv("subm", 0, 5, in_c, base, dx=False)]
    enc = [base]
    prev = base
    for s in range(stages):
        convs.append(Conv("down", s, 2, prev, ch[s]))
        for _ in range(layers[s]):
            convs += [Conv("subm", s + 1, 3, ch[s], ch[s])] * 2
        prev = ch[s]
        enc.append(prev)
    for s in range(stages):
        ref = stages - 1 - s
        dec = ch[stages + s]
        convs.append(Conv("up", ref, 2, prev, dec))
        for b in range(layers[stages + s]):
            cin = dec + enc[ref] if b == 0 else dec
            convs += [Conv("subm", ref, 3, cin, dec), Conv("subm", ref, 3, dec, dec)]
            if cin != dec:
                convs.append(Conv("dense", ref, 1, cin, dec))
        prev = dec
    if classes:
        convs.append(Conv("dense", 0, 1, prev, classes))
    return convs


class LevelStats(NamedTuple):
    rows: List[int]  # rows per level
    pairs3: List[int]  # live pairs of a k3 submanifold conv per level
    pairs5: int  # live pairs of the k5 stem at level 0


def level_stats(rows: torch.Tensor, num_levels: int = 5) -> LevelStats:
    lv = levels(rows, num_levels)
    return LevelStats([int(r.shape[0]) for r in lv],
                      [neighbour_pairs(r, 3) for r in lv],
                      neighbour_pairs(lv[0], 5))


def conv_pairs(conv: Conv, st: LevelStats) -> int:
    """Rows multiplied by the conv's (cin, cout) matrix: live pairs of a
    submanifold conv; one per input row of a down conv (each row feeds one
    output through one tap); one per fine row of an up conv; one per row of
    a dense one."""
    if conv.kind == "subm":
        return st.pairs5 if conv.kernel == 5 else st.pairs3[conv.level]
    return st.rows[conv.level]


def forward_flops(convs: Sequence[Conv], st: LevelStats) -> float:
    """FLOPs of one forward: 2 per pair and channel pair."""
    return sum(2.0 * conv_pairs(c, st) * c.cin * c.cout for c in convs)


def train_flops(convs: Sequence[Conv], st: LevelStats) -> float:
    """FLOPs of one training step: each conv's forward, its dW, and its dx
    where the step takes it (every conv but the stem)."""
    return sum(2.0 * conv_pairs(c, st) * c.cin * c.cout * (3 if c.dx else 2)
               for c in convs)


def subm_call_bound(n: int, pairs: int, cin: int, cout: int, taps: int,
                    backward: bool, dtype, elt: int = 4) -> float:
    """Least seconds of one submanifold conv call over ``n`` rows: its
    forward, or with ``backward`` its dx and dW together. Every operand is
    read once and every result written once (a live pair's input row as a
    4-byte index); 2 FLOPs per pair and channel pair, twice that for dx +
    dW."""
    x, y, w = n * cin * elt, n * cout * elt, taps * cin * cout * elt
    idx = 4 * pairs
    if backward:
        moved = y + x + w + idx + x + taps * cin * cout * 4
        flops = 4.0 * pairs * cin * cout
    else:
        moved = x + w + idx + y
        flops = 2.0 * pairs * cin * cout
    return bound_s(moved, flops, dtype)
