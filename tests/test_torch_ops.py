"""PyTorch port vs JAX package: sparse substrate, rulebooks, plans, band conv.

Integer plan artifacts must be equal exactly (same dtype, shape and values);
float convs agree to 1e-5 (f32 on the CPU, sums in another order). The JAX
band conv runs its Pallas kernel in interpret mode on the CPU, as the JAX
package's own tests run it. JAX functions are jitted whole: one compile per
call is ~10x cheaper than compiling every op of an eager call.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.ops import band_conv as _jbc
from ponderv2_tpu.ops import spconv as _jsp
from ponderv2_tpu.ops.sparse import make_sparse_tensor as jmake
from ponderv2_tpu.ops.sparse import sort_by_key as _jsort
from ponderv2_tpu.ops.sparse import unique_voxels as _junique
from ponderv2_tpu_torch.ops import band_conv as tbc
from ponderv2_tpu_torch.ops import spconv as tsp
from ponderv2_tpu_torch.ops.sparse import make_sparse_tensor as tmake
from ponderv2_tpu_torch.ops.sparse import sort_by_key as tsort
from ponderv2_tpu_torch.ops.sparse import unique_voxels as tunique
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)


class jsp:
    """The JAX spconv functions under test, jitted with static config."""

    build_subm_rulebook = jax.jit(_jsp.build_subm_rulebook, static_argnums=(1, 2, 3))
    build_subm_plan = jax.jit(_jsp.build_subm_plan, static_argnums=(1, 2, 3, 4))
    derive_inner_subm_plan = jax.jit(_jsp.derive_inner_subm_plan, static_argnums=1)
    build_strided_plan = jax.jit(_jsp.build_strided_plan,
                                 static_argnums=(1, 2, 3, 4, 5, 6))
    invert_strided_rulebook = jax.jit(_jsp.invert_strided_rulebook,
                                      static_argnums=1)
    build_inverse_rulebook = jax.jit(_jsp.build_inverse_rulebook,
                                     static_argnums=(1, 2, 4, 5, 6))
    apply_sparse_conv = jax.jit(_jsp.apply_sparse_conv)
    strided_conv_packed = jax.jit(_jsp.strided_conv_packed, static_argnums=4)
    inverse_conv_packed = jax.jit(_jsp.inverse_conv_packed)


class jbc:
    build_band_plan = jax.jit(_jbc.build_band_plan,
                              static_argnums=(1, 2, 3, 4, 5))
    band_subm_conv = jax.jit(_jbc.band_subm_conv, static_argnums=0)


junique = jax.jit(_junique, static_argnums=(1, 2, 3))
jsort = jax.jit(_jsort)


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def make_scene(rng, n, shape, batch, cin, pad_rows=6, sort=True):
    """Unique voxel coords (ascending key order when ``sort``), -1 padding."""
    coords = np.unique(np.stack([
        rng.randint(0, batch, n), rng.randint(0, shape[0], n),
        rng.randint(0, shape[1], n), rng.randint(0, shape[2], n)], 1),
        axis=0).astype(np.int32)
    if not sort:
        coords = coords[rng.permutation(len(coords))]
    feats = rng.randn(len(coords), cin).astype(np.float32)
    coords = np.concatenate([coords, np.full((pad_rows, 4), -1, np.int32)])
    feats = np.concatenate([feats, np.zeros((pad_rows, cin), np.float32)])
    return coords, feats


def assert_same_int(j, t):
    """Exact equality of an integer artifact: dtype, shape and values."""
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    assert j.shape == t.shape, (j.shape, t.shape)
    np.testing.assert_array_equal(j, t)


# shapes: the dense-grid regime (160, 160, 64), and ScanNet's L0 shape where
# the JAX package takes its sorted-key route
SHAPES = [(10, 10, 10), (160, 160, 64), (1024, 1024, 512)]


class TestSubstrate:
    @pytest.mark.parametrize("shape", SHAPES[1:])
    def test_unique_voxels_and_sort(self, rng, shape):
        coords, _ = make_scene(rng, 300, shape, 2, 1, sort=False)
        dup = np.concatenate([coords, coords[:40]])  # repeats and padding
        for cap in (len(dup), 100):
            ju = junique(jnp.asarray(dup), shape, 2, cap)
            tu = tunique(torch.from_numpy(dup), shape, 2, cap)
            for a, b in zip(ju, tu):
                assert_same_int(a, b)
        feats = rng.randn(len(coords), 3).astype(np.float32)
        js, jinv = jsort(jmake(jnp.asarray(feats), jnp.asarray(coords), shape, 2))
        ts, tinv = tsort(tmake(torch.from_numpy(feats), torch.from_numpy(coords),
                               shape, 2))
        assert_same_int(js.coords, ts.coords)
        np.testing.assert_array_equal(np.asarray(jinv), tinv.numpy())
        np.testing.assert_array_equal(np.asarray(js.features), ts.features.numpy())


class TestRulebooks:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("kernel", [3, 5])
    def test_subm_rulebook(self, rng, shape, kernel):
        coords, _ = make_scene(rng, 200, shape, 2, 1)
        j = jsp.build_subm_rulebook(jnp.asarray(coords), shape, 2, kernel)
        t = tsp.build_subm_rulebook(torch.from_numpy(coords), shape, 2, kernel)
        assert_same_int(j, t)

    @pytest.mark.parametrize("sort", [True, False])
    def test_subm_plan_sorted_ok_and_inner(self, rng, sort):
        shape = (12, 12, 12)
        coords, _ = make_scene(rng, 150, shape, 2, 1, sort=sort)
        c = jnp.asarray(coords)
        j5 = jsp.build_subm_plan(c, shape, 2, 5, False)
        j3 = jsp.build_subm_plan(c, shape, 2, 3, True)
        t5 = tsp.build_subm_plan(torch.from_numpy(coords), shape, 2, 5)
        t3 = tsp.build_subm_plan(torch.from_numpy(coords), shape, 2, 3)
        assert bool(j5.sorted_ok) == bool(t5.sorted_ok) == sort
        assert bool(j3.sorted_ok) == bool(t3.sorted_ok)
        assert_same_int(j3.legacy, t3.legacy)
        # the stem-derived L0 plan, gated by sorted_ok like the JAX one
        assert_same_int(jsp.derive_inner_subm_plan(j5, 5).legacy,
                        tsp.derive_inner_subm_plan(t5, 5).legacy)

    @pytest.mark.parametrize("shape", SHAPES[1:])
    def test_strided_packed_plan_and_inverse(self, rng, shape):
        coords, _ = make_scene(rng, 300, shape, 2, 1)
        for cap in (512, 64):  # 64 truncates: overflow rows get parent -1
            j = jsp.build_strided_plan(jnp.asarray(coords), shape, 2, 2, 2, 0, cap)
            t = tsp.build_strided_plan(torch.from_numpy(coords), shape, 2, 2, 2,
                                       0, cap)
            assert tuple(int(d) for d in j.spatial_shape) == t.spatial_shape
            for a, b in [(j.out_coords, t.out_coords), (j.rulebook, t.rulebook),
                         (j.parent, t.parent), (j.tap, t.tap)]:
                assert_same_int(a, b)
            assert_same_int(jsp.invert_strided_rulebook(j.rulebook, len(coords)),
                            tsp.invert_strided_rulebook(t.rulebook, len(coords)))
            assert_same_int(
                jsp.build_inverse_rulebook(j.out_coords, t.spatial_shape, 2,
                                           jnp.asarray(coords), 2, 2, 0),
                tsp.build_inverse_rulebook(t.out_coords, t.spatial_shape, 2,
                                           torch.from_numpy(coords), 2, 2, 0))

    def test_strided_general_plan(self, rng):
        shape = (16, 16, 16)
        coords, _ = make_scene(rng, 200, shape, 2, 1)
        j = jsp.build_strided_plan(jnp.asarray(coords), shape, 2, 3, 2, 1, 400)
        t = tsp.build_strided_plan(torch.from_numpy(coords), shape, 2, 3, 2, 1, 400)
        assert j.parent is None and t.parent is None
        assert_same_int(j.out_coords, t.out_coords)
        assert_same_int(j.rulebook, t.rulebook)


def jband_plan(rb, kw):
    return jbc.build_band_plan(jnp.asarray(rb), 3, kw.get("block"),
                               kw.get("window"), kw.get("pair_budget"),
                               kw.get("entry_budget"))


BAND_CASES = {
    # block 8 / window 32 (tests/test_spconv.py TestBandConv), no overflow
    "b8w32": dict(block=8, window=32),
    # block 32 / window 8: spans overflow the window -> overflow residual
    "b32w8": dict(block=32, window=8),
    # budgets exceeded: ok False and the conv gates to zero
    "pair0": dict(block=32, window=8, pair_budget=0),
    "entry1": dict(block=32, window=8, entry_budget=1),
    # the package defaults (BLOCK 256 / WINDOW 384)
    "default": dict(),
}


class TestBandConv:
    def _scene(self, rng, n=200, shape=(12, 12, 12), cin=5, cout=7):
        coords, feats = make_scene(rng, n, shape, 2, cin)
        rb = np.array(jsp.build_subm_rulebook(jnp.asarray(coords), shape, 2, 3))
        w = (rng.randn(27, cin, cout) * 0.2).astype(np.float32)
        return coords, feats, rb, w

    @pytest.mark.parametrize("case", list(BAND_CASES))
    def test_band_plan_exact(self, rng, case):
        _, _, rb, _ = self._scene(rng)
        kw = BAND_CASES[case]
        j = jband_plan(rb, kw)
        t = tbc.build_band_plan(torch.from_numpy(rb), 3, **kw)
        for f in ("rbt", "w0", "ok", "ov_i", "ov_j", "ov_t"):
            assert_same_int(getattr(j, f), getattr(t, f))
        if case == "b32w8":
            assert bool(t.ok) and sum(t.ov_counts) > 0
        if case in ("pair0", "entry1"):
            assert not bool(t.ok)

    @pytest.mark.parametrize("case,cin,cout", [
        ("b8w32", 5, 7), ("b8w32", 40, 24), ("b32w8", 5, 7), ("b32w8", 40, 24),
        ("pair0", 5, 7), ("entry1", 5, 7)])
    def test_band_subm_conv_forward(self, rng, case, cin, cout):
        coords, feats, rb, w = self._scene(rng, cin=cin, cout=cout)
        kw = BAND_CASES[case]
        block, window = kw["block"], kw["window"]
        jplan = jband_plan(rb, kw)
        st = jmake(jnp.asarray(feats), jnp.asarray(coords), (12, 12, 12), 2)
        ref = np.asarray(jbc.band_subm_conv(
            (3, block, window), st.features, jplan, jnp.asarray(w), st.mask,
            jnp.zeros((0,), jnp.float32)))
        tplan = tbc.build_band_plan(torch.from_numpy(rb), 3, **kw)
        mask = torch.from_numpy(coords[:, 0] >= 0)
        out = tbc.band_subm_conv((3, block, window), torch.from_numpy(feats),
                                 tplan, torch.from_numpy(w), mask).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        if not bool(tplan.ok):
            assert np.abs(out).sum() == 0.0
        else:  # and the band conv is the plain subm conv
            plain = tsp.apply_sparse_conv(torch.from_numpy(feats),
                                          torch.from_numpy(rb),
                                          torch.from_numpy(w), mask).numpy()
            np.testing.assert_allclose(out, plain, rtol=1e-5, atol=1e-5)

    def test_band_core_plain_drops_out_of_window(self, rng):
        """The plain K1 drops exactly what the overflow list holds."""
        coords, feats, rb, w = self._scene(rng)
        plan = tbc.build_band_plan(torch.from_numpy(rb), 3, block=32, window=8)
        f, wt = torch.from_numpy(feats), torch.from_numpy(w)
        core = tbc.band_fwd_core(f, plan.rbt, plan.w0, wt, 3, 32, 8)
        full = tsp.apply_sparse_conv(f, torch.from_numpy(rb), wt,
                                     torch.ones(len(feats), dtype=torch.bool))
        resid = tbc._overflow_residual(f, plan.ov_j, plan.ov_i, plan.ov_order,
                                       plan.ov_counts, wt, len(feats),
                                       torch.float32)
        assert resid.abs().sum() > 0
        np.testing.assert_allclose((core + resid).numpy(), full.numpy(),
                                   rtol=1e-5, atol=1e-5)


class TestDenseConvs:
    @pytest.mark.parametrize("kernel", [3, 5])
    def test_apply_sparse_conv(self, rng, kernel):
        shape = (10, 10, 10)
        coords, feats = make_scene(rng, 120, shape, 2, 6)
        rb = np.array(jsp.build_subm_rulebook(jnp.asarray(coords), shape, 2, kernel))
        w = (rng.randn(kernel ** 3, 6, 9) * 0.2).astype(np.float32)
        mask = coords[:, 0] >= 0
        ref = np.asarray(jsp.apply_sparse_conv(jnp.asarray(feats), jnp.asarray(rb),
                                               jnp.asarray(w), jnp.asarray(mask)))
        out = tsp.apply_sparse_conv(torch.from_numpy(feats), torch.from_numpy(rb),
                                    torch.from_numpy(w), torch.from_numpy(mask))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)

    def test_strided_and_inverse_packed(self, rng):
        shape = (16, 16, 16)
        coords, feats = make_scene(rng, 200, shape, 2, 6)
        j = jsp.build_strided_plan(jnp.asarray(coords), shape, 2, 2, 2, 0, 256)
        t = tsp.build_strided_plan(torch.from_numpy(coords), shape, 2, 2, 2, 0, 256)
        w = (rng.randn(8, 6, 5) * 0.3).astype(np.float32)
        omask = np.array(j.out_coords[:, 0] >= 0, copy=True)
        ref = np.asarray(jsp.strided_conv_packed(
            jnp.asarray(feats), j.parent, j.tap, jnp.asarray(w), 256,
            jnp.asarray(omask)))
        out = tsp.strided_conv_packed(
            torch.from_numpy(feats), t.parent, t.tap, torch.from_numpy(w), 256,
            torch.from_numpy(omask))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
        coarse = rng.randn(256, 5).astype(np.float32)
        wi = (rng.randn(8, 5, 4) * 0.3).astype(np.float32)
        fmask = coords[:, 0] >= 0
        ref = np.asarray(jsp.inverse_conv_packed(
            jnp.asarray(coarse), j.parent, j.tap, jnp.asarray(wi),
            jnp.asarray(fmask)))
        out = tsp.inverse_conv_packed(
            torch.from_numpy(coarse), t.parent, t.tap, torch.from_numpy(wi),
            torch.from_numpy(fmask))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
