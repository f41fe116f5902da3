"""PyTorch port vs JAX package: ``ops/pointops.py`` and the ``ops/sparse.py``
helpers on the CPU.

Each test feeds the same seeded numpy inputs to the JAX function and to
the port. Tolerances: integer outputs (indices, batch ids, offsets)
exactly; f32 values within 1e-5 of max|ref| (distances in the same
expanded form, sums in another order); grads within 1e-5 of max|ref|. The
JAX grads and the sparse helpers run jitted, as they compile faster so.
The search inputs keep a gap between each query's nearest distances (or
compare distances where ties are possible), since ``jax.lax.top_k`` and
``torch.topk`` may order equal distances differently.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.ops import pointops as jpo
from ponderv2_tpu.ops import sparse as jsp
from ponderv2_tpu_torch.ops import pointops as tpo
from ponderv2_tpu_torch.ops import sparse as tsp
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.asarray(x))


def assert_rel(out, ref, bound=1e-5, where=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (where, out.shape, ref.shape)
    err = np.abs(out - ref).max() if out.size else 0.0
    scale = np.abs(ref).max() if ref.size else 0.0
    assert err <= bound * max(scale, 1e-30), f"{where}: err {err:.3e} vs {scale:.3e}"


def cloud(rng, n, batches=2, pad=3, scale=1.0):
    """``n`` points uniform in the cube of side ``scale``, in ``batches``
    sorted batches, plus ``pad`` padding rows (batch -1)."""
    xyz = (rng.rand(n + pad, 3) * scale).astype(np.float32)
    batch = np.sort(rng.randint(0, batches, n + pad)).astype(np.int32)
    batch[n:] = -1
    return xyz, batch


def no_ties(xyz, ref, qb, rb, k, gap=1e-5):
    """True when every query's k+1 nearest same-batch squared distances
    differ by more than ``gap`` (float64)."""
    for i in range(len(xyz)):
        if qb[i] < 0:
            continue
        d = ((ref[rb == qb[i]] - xyz[i]) ** 2).sum(1).astype(np.float64)
        d = np.sort(d)[:k + 1]
        if len(d) > 1 and np.diff(d).min() <= gap:
            return False
    return True


@pytest.mark.parametrize("k,chunk,direct", [(1, 2048, False), (4, 16, False),
                                            (1, 2048, True), (4, 16, True)])
def test_knn_query_matches_jax(rng, k, chunk, direct):
    """Indices exactly, distances within 1e-5 (with padding queries and
    refs, and a chunk smaller than the query count). The direct form
    (``direct``, which JAX has not) gives JAX's indices, and distances
    within 1e-6 of max|ref| of float64 on the same f32 points."""
    ref, rb = cloud(rng, 120)
    q, qb = cloud(rng, 50)
    assert no_ties(q, ref, qb, rb, k)
    jidx, jd = jpo.knn_query(k, jnp.asarray(ref), jnp.asarray(rb), jnp.asarray(q),
                             jnp.asarray(qb), chunk=chunk)
    tidx, td = tpo.knn_query(k, t(ref), t(rb), t(q), t(qb), chunk=chunk, direct=direct)
    valid = qb >= 0
    assert tidx.dtype == torch.int32 and tidx.shape == (len(q), k)
    np.testing.assert_array_equal(tidx.numpy()[valid], np.asarray(jidx)[valid])
    if direct:
        d64 = ((q[:, None].astype(np.float64) - ref[tidx.numpy()]) ** 2).sum(-1)
        assert_rel(td.numpy()[valid], d64[valid], 1e-6, "direct sqdist")
    else:
        assert_rel(td.numpy(), jd, 1e-5, "sqdist")
    # self query: the defaults take the refs as queries
    jidx, _ = jpo.knn_query(k, jnp.asarray(ref), jnp.asarray(rb))
    tidx, _ = tpo.knn_query(k, t(ref), t(rb), direct=direct)
    np.testing.assert_array_equal(tidx.numpy()[rb >= 0], np.asarray(jidx)[rb >= 0])


def test_knn_query_ties_take_the_lower_index():
    """Equal distances come out lowest index first, as ``top_k`` gives."""
    ref = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, 0, 3]], np.float32)
    b = np.zeros(4, np.int32)
    q = np.zeros((1, 3), np.float32)
    for k in (1, 3):
        jidx, jd = jpo.knn_query(k, jnp.asarray(ref), jnp.asarray(b), jnp.asarray(q),
                                 jnp.asarray(b[:1]))
        tidx, td = tpo.knn_query(k, t(ref), t(b), t(q), t(b[:1]))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tidx.numpy()[0], np.arange(k))


@pytest.mark.parametrize("min_radius", [0.0, 0.1])
def test_ball_query_matches_jax(rng, min_radius):
    """Indices exactly (short lists filled with the first hit; a query with
    no hit gets ref 0), distances within 1e-5."""
    ref, rb = cloud(rng, 150)
    q, qb = cloud(rng, 40)
    q[:3] += 5.0  # far from every ref: no hit
    args = (0.25, 8)
    jidx, jd = jpo.ball_query(*args, jnp.asarray(ref), jnp.asarray(rb), jnp.asarray(q),
                              jnp.asarray(qb), min_radius=min_radius, chunk=16)
    tidx, td = tpo.ball_query(*args, t(ref), t(rb), t(q), t(qb), min_radius=min_radius,
                              chunk=16)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert_rel(td.numpy(), jd, 1e-5, "sqdist")
    assert (tidx.numpy()[:3] == 0).all()


def test_random_ball_query_matches_jax_with_its_permutation(rng):
    """JAX's permutation injected as ``rank_of_row``: indices exactly (-1
    fill), distances within 1e-5; drawn from a generator, every hit is in
    radius and in batch."""
    n, m, nsample = 80, 25, 6
    ref, rb = cloud(rng, n, pad=0)
    q, qb = cloud(rng, m, pad=2)
    rank = rng.permutation(n).astype(np.int32)
    jidx, jd = jpo.random_ball_query(jax.random.PRNGKey(0), 0.5, nsample, jnp.asarray(ref),
                                     jnp.asarray(rb), jnp.asarray(q), jnp.asarray(qb),
                                     min_radius=0.1, rank_of_row=jnp.asarray(rank))
    tidx, td = tpo.random_ball_query(None, 0.5, nsample, t(ref), t(rb), t(q), t(qb),
                                     min_radius=0.1, rank_of_row=t(rank))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert_rel(td.numpy(), jd, 1e-5, "dist")
    gidx, gd = tpo.random_ball_query(torch.Generator().manual_seed(1), 0.5, nsample,
                                     t(ref), t(rb), t(q), t(qb))
    hit = gidx.numpy() >= 0
    assert hit.any()
    assert (gd.numpy()[hit] < 0.5).all()
    assert (rb[gidx.numpy()[hit]] == np.broadcast_to(qb[:, None], hit.shape)[hit]).all()


@pytest.mark.parametrize("with_xyz", [False, True])
def test_query_and_group_match_jax(rng, with_xyz):
    """``knn_query_and_group`` and ``ball_query_and_group`` (the latter with
    a given idx holding -1 entries): grouped features within 1e-5, indices
    exactly, and the grads of the grouped features within 1e-5."""
    xyz, b = cloud(rng, 40, pad=0)
    feat = rng.randn(40, 5).astype(np.float32)
    cot = rng.randn(40, 4, 5 + 3 * with_xyz).astype(np.float32)
    assert no_ties(xyz, xyz, b, b, 4)

    def jfn(f):
        g, idx = jpo.knn_query_and_group(f, jnp.asarray(xyz), jnp.asarray(b), nsample=4,
                                         with_xyz=with_xyz)
        return jnp.sum(g * cot), (g, idx)

    (_, (jg, jidx)), jgrad = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jnp.asarray(feat))
    f = t(feat).requires_grad_()
    tg, tidx = tpo.knn_query_and_group(f, t(xyz), t(b), nsample=4, with_xyz=with_xyz)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert_rel(tg.detach().numpy(), jg, 1e-5, "knn grouped")
    (tg * t(cot)).sum().backward()
    assert_rel(f.grad.numpy(), jgrad, 1e-5, "grad")

    idx = np.stack([np.arange(40), np.full(40, -1), rng.randint(0, 40, 40),
                    rng.randint(0, 40, 40)], 1).astype(np.int32)
    jg, _ = jpo.ball_query_and_group(jnp.asarray(feat), jnp.asarray(xyz), jnp.asarray(b),
                                     idx=jnp.asarray(idx), with_xyz=with_xyz)
    tg, _ = tpo.ball_query_and_group(t(feat), t(xyz), t(b), idx=t(idx), with_xyz=with_xyz)
    assert_rel(tg.numpy(), jg, 1e-5, "ball grouped")
    assert (tg.numpy()[:, 1] == 0).all()
    jg, jidx = jpo.ball_query_and_group(jnp.asarray(feat), jnp.asarray(xyz), jnp.asarray(b),
                                        max_radius=0.4, nsample=6, with_xyz=with_xyz)
    tg, tidx = tpo.ball_query_and_group(t(feat), t(xyz), t(b), max_radius=0.4, nsample=6,
                                        with_xyz=with_xyz)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert_rel(tg.numpy(), jg, 1e-5, "ball query grouped")


def test_farthest_point_sampling_matches_jax(rng):
    """Indices exactly, masked rows never taken, the first valid row first."""
    xyz = rng.rand(300, 3).astype(np.float32)
    mask = rng.rand(300) > 0.3
    mask[:4] = False
    jidx = jpo.farthest_point_sampling(jnp.asarray(xyz), jnp.asarray(mask), 40)
    tidx = tpo.farthest_point_sampling(t(xyz), t(mask), 40)
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert mask[tidx.numpy()].all() and tidx[0] == np.argmax(mask)


def test_grouping_subtraction_aggregation_match_jax(rng):
    """Outputs within 1e-5 and every grad (features, positions, weights)
    within 1e-5; idx -1 entries take the last row, as numpy indexing does."""
    n, m, k, c, wc = 30, 12, 5, 8, 2
    feat = rng.randn(n, c).astype(np.float32)
    fq = rng.randn(m, c).astype(np.float32)
    pos = rng.randn(m, k, c).astype(np.float32)
    w = rng.randn(m, k, wc).astype(np.float32)
    idx = rng.randint(-1, n, (m, k)).astype(np.int32)
    cots = [rng.randn(m, k, c), rng.randn(m, k, c), rng.randn(m, c)]
    cots = [x.astype(np.float32) for x in cots]

    def jfn(f, q, p, ww):
        outs = (jpo.grouping(f, jnp.asarray(idx)), jpo.subtraction(q, f, jnp.asarray(idx)),
                jpo.aggregation(f, p, ww, jnp.asarray(idx)))
        return sum(jnp.sum(o * x) for o, x in zip(outs, cots)), outs

    (_, jouts), jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(x) for x in (feat, fq, pos, w)))
    ins = [t(x).requires_grad_() for x in (feat, fq, pos, w)]
    f, q, p, ww = ins
    touts = (tpo.grouping(f, t(idx)), tpo.subtraction(q, f, t(idx)),
             tpo.aggregation(f, p, ww, t(idx)))
    for name, o, jo in zip(("grouping", "subtraction", "aggregation"), touts, jouts):
        assert_rel(o.detach().numpy(), jo, 1e-5, name)
    sum((o * t(x)).sum() for o, x in zip(touts, cots)).backward()
    for name, x, jg in zip(("feat", "query", "position", "weight"), ins, jgrads):
        assert_rel(x.grad.numpy(), jg, 1e-5, f"grad {name}")


def test_interpolation_matches_jax(rng):
    """Values within 1e-5 and the grads w.r.t. the features and both point
    sets (through the kNN distances) within 1e-5."""
    src, sb = cloud(rng, 60, pad=0)
    dst, db = cloud(rng, 25, pad=0)
    assert no_ties(dst, src, db, sb, 3)
    feat = rng.randn(60, 4).astype(np.float32)
    cot = rng.randn(25, 4).astype(np.float32)

    def jfn(s, d, f):
        out = jpo.interpolation(s, jnp.asarray(sb), d, jnp.asarray(db), f)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(feat))
    ins = [t(x).requires_grad_() for x in (src, dst, feat)]
    out = tpo.interpolation(ins[0], t(sb), ins[1], t(db), ins[2])
    assert_rel(out.detach().numpy(), jout, 1e-5, "interpolation")
    (out * t(cot)).sum().backward()
    for name, x, jg in zip(("src", "dst", "features"), ins, jgrads):
        assert_rel(x.grad.numpy(), jg, 1e-5, f"grad {name}")


def test_attention_steps_match_jax(rng):
    """The relation and fusion steps over random edges (targets out of range
    dropped by the fusion's segment sum): values and every grad within
    1e-5."""
    n, e, c = 20, 70, 6
    qv, kv, vv = (rng.randn(n, c).astype(np.float32) for _ in range(3))
    w_rel = rng.randn(c).astype(np.float32)
    w_fus = rng.randn(e, c).astype(np.float32)
    it = rng.randint(0, n, e).astype(np.int32)
    it[:3] = n + 2  # dropped by the segment sum
    ir = rng.randint(0, n, e).astype(np.int32)
    cot_r = rng.randn(e, c).astype(np.float32)
    cot_f = rng.randn(n, c).astype(np.float32)

    def jfn(q, k, wr, wf, v):
        rel = jpo.attention_relation_step(q, k, wr, jnp.asarray(it) % n, jnp.asarray(ir))
        fus = jpo.attention_fusion_step(wf, v, jnp.asarray(it), jnp.asarray(ir), n)
        return jnp.sum(rel * cot_r) + jnp.sum(fus * cot_f), (rel, fus)

    (_, (jrel, jfus)), jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2, 3, 4),
                                                           has_aux=True))(
        *(jnp.asarray(x) for x in (qv, kv, w_rel, w_fus, vv)))
    ins = [t(x).requires_grad_() for x in (qv, kv, w_rel, w_fus, vv)]
    rel = tpo.attention_relation_step(ins[0], ins[1], ins[2], t(it % n), t(ir))
    fus = tpo.attention_fusion_step(ins[3], ins[4], t(it), t(ir), n)
    assert_rel(rel.detach().numpy(), jrel, 1e-5, "relation")
    assert_rel(fus.detach().numpy(), jfus, 1e-5, "fusion")
    ((rel * t(cot_r)).sum() + (fus * t(cot_f)).sum()).backward()
    for name, x, jg in zip(("query", "key", "w_rel", "w_fus", "value"), ins, jgrads):
        assert_rel(x.grad.numpy(), jg, 1e-5, f"grad {name}")


def test_pairwise_sqdist_matches_jax(rng):
    q = rng.randn(9, 3).astype(np.float32) * 3
    r = rng.randn(14, 3).astype(np.float32) * 3
    assert_rel(tpo._pairwise_sqdist(t(q), t(r)).numpy(),
               jpo._pairwise_sqdist(jnp.asarray(q), jnp.asarray(r)), 1e-5, "sqdist")


# ------------------------------------------------------------- sparse helpers


@pytest.mark.parametrize("reduce", ["mean", "sum"])
def test_voxel_pool_and_to_dense_match_jax(rng, reduce):
    """Pooled features within 1e-5, unique coords and inverse map exactly
    (with repeats, padding rows and overflow past the capacity), then the
    dense volume in both layouts within 1e-5."""
    shape, bs, cap = (6, 5, 4), 2, 40
    coords = np.stack([rng.randint(0, bs, 90), rng.randint(0, 6, 90),
                       rng.randint(0, 5, 90), rng.randint(0, 4, 90)], 1).astype(np.int32)
    coords[-5:] = -1
    feat = rng.randn(90, 3).astype(np.float32)
    jst, jinv = jax.jit(lambda f, c: jsp.voxel_pool(f, c, shape, bs, cap, reduce))(
        jnp.asarray(feat), jnp.asarray(coords))
    tst, tinv = tsp.voxel_pool(t(feat), t(coords), shape, bs, cap, reduce)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(tst.coords.numpy(), np.asarray(jst.coords))
    assert_rel(tst.features.numpy(), jst.features, 1e-5, "pooled")
    for channels_last in (False, True):
        assert_rel(tsp.to_dense(tst, channels_last).numpy(),
                   jax.jit(lambda st: jsp.to_dense(st, channels_last))(jst), 1e-5, "dense")


def test_offset_batch_round_trip_matches_jax():
    offset = np.array([3, 7, 7, 12], np.int32)
    jb = jsp.offset2batch(jnp.asarray(offset), 15)
    tb = tsp.offset2batch(t(offset), 15)
    assert tb.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    jo = jsp.batch2offset(jb, 4)
    to = tsp.batch2offset(tb, 4)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(to.numpy(), offset)
