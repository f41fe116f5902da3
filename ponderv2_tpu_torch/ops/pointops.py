"""Point-cloud ops: KNN, ball query, FPS, grouping, interpolation, attention steps.

Counterpart of ``ponderv2_tpu/ops/pointops.py`` (the reference's pointops
CUDA library, ``libs/pointops``), as plain PyTorch with the same contracts:
batched point clouds carry per-row int32 batch ids (padding rows -1), the
searches return ``(idx int32, sqdist)`` with a static count per query, and
queries run in chunks of ``chunk`` rows against all refs (a chunk of 2048
queries against 85k refs holds 0.7 GB of f32 distances).

Distances take the JAX form ``|q|^2 + |r|^2 - 2 q.r``, with the product as
three exact f32 multiplies and adds (never TF32). It cancels: at |x| ~ 5 m
its f32 error on d^2 is ~1e-5, so where the two nearest refs lie closer
than that a search may pick the other one, and d^2 can come out negative.
``knn_query(direct=True)`` sums the squared coordinate differences instead
(no cancellation, about three times the memory traffic); the evaluator's
projection of labels onto the original points takes it.
Selections take the smallest first and, among equal distances, the lowest
index (as ``jax.lax.top_k``); where more than ``k`` refs tie at the k-th
place, which of them are kept may differ from JAX's choice. Gathers whose
grads flow (``grouping`` and the ops over neighbour indices) add their
backward in a fixed order (``ops/scatter.py``), as does
``attention_fusion_step``'s segment sum, so a step on the GPU gives the
same bits run to run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .scatter import ordered_gather, segment_sum

_BIG = 1e10


def _pairwise_sqdist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(M, D), (N, D) -> (M, N) squared distances |q|^2 + |r|^2 - 2 q.r."""
    qq = (q * q).sum(1, keepdim=True)
    rr = (r * r).sum(1, keepdim=True)
    qr = q[:, 0:1] * r[:, 0]
    for c in range(1, q.shape[1]):
        qr = qr + q[:, c:c + 1] * r[:, c]
    return qq + rr.T - 2.0 * qr


def _direct_sqdist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(M, D), (N, D) -> (M, N) squared distances sum_c (q_c - r_c)^2."""
    d = (q[:, 0:1] - r[:, 0]).square_()
    for c in range(1, q.shape[1]):
        d += (q[:, c:c + 1] - r[:, c]).square_()
    return d


def _smallest(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row, ascending, ties by lower index."""
    if k == 1:
        val, idx = d.min(1, keepdim=True)  # the first minimum
        return val, idx
    val, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
    idx, order = torch.sort(idx, dim=1)
    val = val.gather(1, order)
    val, order = torch.sort(val, dim=1, stable=True)
    return val, idx.gather(1, order)


def _search(query_xyz, query_batch, ref_xyz, chunk, pick, sqdist=_pairwise_sqdist):
    """``pick(d, q_batch)`` on each chunk of ``chunk`` queries' squared
    distances to every ref; its outputs concatenated over the chunks."""
    parts = [pick(sqdist(query_xyz[s:s + chunk], ref_xyz), query_batch[s:s + chunk])
             for s in range(0, query_xyz.shape[0], chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def knn_query(
    k: int,
    ref_xyz: torch.Tensor,
    ref_batch: torch.Tensor,
    query_xyz: Optional[torch.Tensor] = None,
    query_batch: Optional[torch.Tensor] = None,
    chunk: int = 2048,
    direct: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force k nearest neighbours within matching batch elements.

    Returns (idx (M, k) int32 into ref rows, sqdist (M, k)). A query with
    batch -1, or with fewer than k valid refs in its batch, still gets k
    indices (distance 1e10 past its valid refs), as the reference kernel
    always returns k. ``direct``: distances as summed squared differences,
    not the JAX function's expanded form."""
    if query_xyz is None:
        query_xyz, query_batch = ref_xyz, ref_batch
    ref_bad = ref_batch < 0

    def pick(d, cb):
        d = d.masked_fill((cb[:, None] != ref_batch[None, :]) | ref_bad[None, :], _BIG)
        v, i = _smallest(d, k)
        return i.to(torch.int32), v

    return _search(query_xyz, query_batch, ref_xyz, chunk, pick,
                   _direct_sqdist if direct else _pairwise_sqdist)


def ball_query(
    radius: float,
    nsample: int,
    ref_xyz: torch.Tensor,
    ref_batch: torch.Tensor,
    query_xyz: torch.Tensor,
    query_batch: torch.Tensor,
    min_radius: float = 0.0,
    chunk: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-radius neighbour query (reference ball_query semantics: the
    first ``nsample`` in-radius refs by index; short lists are filled with
    the first hit, and a query with no hit gets ref 0 throughout, as the JAX
    function's ``top_k`` gives). Returns (idx (M, nsample) int32, sqdist).

    Hits rank by their index held as f32, which is exact below 2^24 refs."""
    r2_max, r2_min = radius * radius, min_radius * min_radius
    order = torch.arange(ref_xyz.shape[0], dtype=torch.float32, device=ref_xyz.device)
    ref_bad = ref_batch < 0

    def pick(d, cb):
        bad = ((cb[:, None] != ref_batch[None, :]) | ref_bad[None, :]
               | (d > r2_max) | (d < r2_min))
        rank = torch.where(bad, _BIG, order[None, :])
        val, i = torch.topk(rank, nsample, dim=1, largest=False, sorted=True)
        hit = val < _BIG
        i = torch.where(hit, i, torch.where(hit[:, :1], i[:, :1], 0))
        return i.to(torch.int32), d.gather(1, i)

    return _search(query_xyz, query_batch, ref_xyz, chunk, pick)


def random_ball_query(
    generator: Optional[torch.Generator],
    radius: float,
    nsample: int,
    ref_xyz: torch.Tensor,
    ref_batch: torch.Tensor,
    query_xyz: torch.Tensor,
    query_batch: torch.Tensor,
    min_radius: float = 0.0,
    chunk: int = 2048,
    rank_of_row: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random-subset ball query (reference random_ball_query): refs are
    scanned in a random permutation (``rank_of_row``, else drawn from
    ``generator``) and the first ``nsample`` hits kept, a hit being
    ``d2 <= 1e-5`` (self) or ``min_r2 <= d2 < max_r2``. Short lists are
    filled with idx -1 and distance 1e10; distances are returned as sqrt,
    as the reference wrapper returns them. The JAX function takes a key
    where this takes the generator."""
    n = ref_xyz.shape[0]
    if rank_of_row is None:
        perm = torch.randperm(n, generator=generator, device=ref_xyz.device)
        rank_of_row = torch.empty(n, dtype=torch.int32, device=ref_xyz.device)
        rank_of_row[perm] = torch.arange(n, dtype=torch.int32, device=ref_xyz.device)
    rank_f = rank_of_row.to(torch.float32)
    r2_max, r2_min = radius * radius, min_radius * min_radius

    def pick(d, cb):
        hit = ((cb[:, None] == ref_batch[None, :]) & (ref_batch[None, :] >= 0)
               & ((d <= 1e-5) | ((d >= r2_min) & (d < r2_max))))
        rank = torch.where(hit, rank_f[None, :], _BIG)
        val, i = torch.topk(rank, nsample, dim=1, largest=False, sorted=True)
        found = val < _BIG
        return (torch.where(found, i, -1).to(torch.int32),
                torch.where(found, d.gather(1, i), _BIG))

    idx, dist2 = _search(query_xyz, query_batch, ref_xyz, chunk, pick)
    return idx, torch.sqrt(torch.clamp(dist2, min=0.0))


def _group(feat, xyz, new_xyz, idx, with_xyz):
    """Gather neighbour features by idx; ``with_xyz`` prepends neighbour
    positions relative to the query point. idx -1 entries give zeros."""
    safe = idx.clamp(min=0)
    valid = (idx >= 0)[..., None]
    grouped = torch.where(valid, grouping(feat, safe), 0.0)
    if with_xyz:
        rel = torch.where(valid, grouping(xyz, safe) - new_xyz[:, None, :], 0.0)
        grouped = torch.cat([rel, grouped], -1)
    return grouped


def knn_query_and_group(feat, xyz, batch, new_xyz=None, new_batch=None, idx=None,
                        nsample: Optional[int] = None, with_xyz: bool = False):
    """KNN + grouping composite (reference utils.py:5-23)."""
    if new_xyz is None:
        new_xyz, new_batch = xyz, batch
    if idx is None:
        assert nsample is not None
        idx, _ = knn_query(nsample, xyz, batch, new_xyz, new_batch)
    return _group(feat, xyz, new_xyz, idx, with_xyz), idx


def ball_query_and_group(feat, xyz, batch, new_xyz=None, new_batch=None, idx=None,
                         max_radius: Optional[float] = None, min_radius: float = 0.0,
                         nsample: Optional[int] = None, with_xyz: bool = False):
    """Ball query + grouping composite (reference utils.py:26-45)."""
    if new_xyz is None:
        new_xyz, new_batch = xyz, batch
    if idx is None:
        assert nsample is not None and max_radius is not None
        idx, _ = ball_query(max_radius, nsample, xyz, batch, new_xyz, new_batch,
                            min_radius=min_radius)
    return _group(feat, xyz, new_xyz, idx, with_xyz), idx


def farthest_point_sampling(xyz: torch.Tensor, mask: torch.Tensor,
                            n_samples: int) -> torch.Tensor:
    """Iterative FPS over one point set (masked-out rows excluded): starts at
    the first valid row, then takes the row farthest from those taken (the
    first such row on a tie). Returns (n_samples,) int32. One step runs a
    few small kernels; the loop stays on the device with no host sync."""
    start = torch.argmax(mask.to(torch.int32))
    far = torch.full_like(xyz[:, 0], -_BIG)
    dist = torch.where(mask, _BIG, far)
    picks = [start]
    for _ in range(1, n_samples):
        last = xyz.index_select(0, picks[-1].reshape(1))
        d = ((xyz - last) ** 2).sum(1)
        dist = torch.minimum(dist, torch.where(mask, d, far))
        picks.append(torch.argmax(dist))
    return torch.stack(picks).to(torch.int32)


def grouping(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather neighbour features: (N, C), (M, k) -> (M, k, C); the backward
    adds into each row in a fixed order."""
    return ordered_gather(features, idx)


def interpolation(src_xyz, src_batch, dst_xyz, dst_batch, features, k: int = 3,
                  eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance-weighted kNN feature interpolation (src -> dst)
    (reference interpolation.py:8-59)."""
    idx, sqdist = knn_query(k, src_xyz, src_batch, dst_xyz, dst_batch)
    w = 1.0 / (torch.sqrt(torch.clamp(sqdist, min=0.0)) + eps)
    w = w / w.sum(1, keepdim=True)
    return (grouping(features, idx) * w[..., None]).sum(1)


def subtraction(feat_q: torch.Tensor, feat_r: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """Pairwise neighbourhood subtraction: (M,C),(N,C),(M,k) -> (M,k,C)."""
    return feat_q[:, None, :] - grouping(feat_r, idx)


def aggregation(feat: torch.Tensor, position: torch.Tensor, weight: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """Weighted neighbour aggregation (point-transformer style):
    out[m] = sum_k (feat[idx[m,k]] + position[m,k]) * weight[m,k], the weight
    broadcast over channel groups (C = G * weight_channels)."""
    m, k = idx.shape
    c = feat.shape[1]
    wc = weight.shape[2]
    gathered = (grouping(feat, idx) + position).reshape(m, k, wc, c // wc)
    return (gathered * weight[..., None]).sum(1).reshape(m, c)


def attention_relation_step(query, key, weight, index_target, index_refer):
    """Sparse attention relation: out[i] = q[it[i]] * k[ir[i]] * w."""
    return grouping(query, index_target) * grouping(key, index_refer) * weight[None, :]


def attention_fusion_step(weight, value, index_target, index_refer, num_outputs: int):
    """Sparse attention fusion: out[t] += w[i] * v[ir[i]] summed by target,
    in a fixed order (targets outside [0, num_outputs) are dropped)."""
    contrib = weight * grouping(value, index_refer)
    return segment_sum(contrib, index_target, num_outputs)
