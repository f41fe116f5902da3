"""PyTorch port vs JAX package: the MinkUNet family, SpUNet-v1m1's
``cls_mode`` (and its v1m2 alias), SpUNetNoSkipBase and DefaultClassifier
(over ``cls_mode`` and over the U-Net's per-voxel rows) on the CPU.

Each JAX model gets random weights from a seed (shapes by ``jax.eval_shape``
of its init), without ``nn.remat`` (ROADMAP Queue 3), and one jitted
function per model gives its eval forward (with ``contract_ok``) and a
training loss, its grads and the moved BN statistics; its band convs run
their Pallas kernels in interpret mode. The port's model loads the same
weights through ``utils/convert.py`` and is held to it: f32 outputs, loss
and every gradient within 1e-5 of max|ref|, the moved running statistics
too, ``contract_ok`` equal, and the integer plans (each level's rulebook and
band plan) equal. The widths are the smallest that put one level over 64
channels, so that level's blocks take the band conv.

The JAX runs (``jax_run``) and the checks against them
(``check_backbone_matches_jax``) live here; ``test_backbone_matches_jax``
runs them in ``test_torch_backbones_mink.py`` (MinkUNet14A),
``test_torch_backbones_mink50.py`` (MinkUNet50),
``test_torch_backbones_spunet.py`` (SpUNetNoSkipBase) and
``test_torch_backbones_cls.py`` (the two classifiers), one module fixture
per model.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ponderv2_tpu.models import build_model as jbuild
from ponderv2_tpu.ops import spconv as jsp
from ponderv2_tpu.ops.sparse import make_sparse_tensor as jmake
from ponderv2_tpu_torch.models import MODELS as TMODELS
from ponderv2_tpu_torch.models import build_model as tbuild
from ponderv2_tpu_torch.models.sparse_unet.layers import SubMConv
from ponderv2_tpu_torch.models.sparse_unet.mink_unet import _VARIANTS
from ponderv2_tpu_torch.ops import spconv as tsp
from ponderv2_tpu_torch.ops.sparse import make_sparse_tensor as tmake
from ponderv2_tpu_torch.utils.convert import (
    state_dict_from_jax_backbone,
    state_dict_from_jax_classifier,
)
from jax_compile import jit  # noqa: E402
from torch_threads import _torch_threads  # noqa: F401, E402  (autouse fixture)

SHAPE = (32, 32, 16)
CAP = 512
REL = 1e-5
CE = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]
# one or two stages (the models take any even number of layers) keep the JAX
# compiles short: one model's eval forward and training step take 40-80 s
SPUNET = dict(in_channels=6, base_channels=8, channels=(16, 72, 16, 16), layers=(1,) * 4)
CASES = {
    # basic blocks: L1 at 16 channels, L2 at 72 (its plan attached in the
    # encoder), the decoder at L1 72 wide (its plan attached there), the last
    # decoder stage at L0 narrow
    "MinkUNet14A": dict(type="MinkUNet14A", in_channels=6, out_channels=5, init_dim=8,
                        planes=(16, 72, 72, 16), layers=(1, 1, 1, 1)),
    # bottleneck blocks (4x expansion) at one stage, scanned in JAX: L1's two
    # blocks 96 wide (their k3 conv 24, on L1's attached plan), the decoder's
    # at L0 32 wide (a standalone first block with a shortcut projection,
    # then a stack of one)
    "MinkUNet50": dict(type="MinkUNet50", in_channels=6, out_channels=5, init_dim=8,
                       planes=(24, 8), layers=(2, 2)),
    # plain rulebooks: L2's convs build their band plans inline
    "SpUNetNoSkipBase": dict(type="SpUNetNoSkipBase", num_classes=5, **SPUNET),
    # SpUNet-v1m1's cls_mode at 7 classes under the classifier's cls_head
    "DefaultClassifier": dict(type="DefaultClassifier", num_classes=4, backbone_embed_dim=7,
                              criteria=CE, backbone=dict(type="SpUNet-v1m1", num_classes=7,
                                                         cls_mode=True, **SPUNET)),
    # the classifier over a one-stage U-Net's per-voxel rows (L1 at 72),
    # pooled per scene
    "DefaultClassifier-repool": dict(
        type="DefaultClassifier", num_classes=4, backbone_embed_dim=16, criteria=CE,
        backbone=dict(type="SpUNet-v1m1", num_classes=0, in_channels=6, base_channels=8,
                      channels=(72, 16), layers=(1, 1))),
}


@pytest.fixture(autouse=True)
def _torch_state():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


def assert_rel(out, ref, bound, where=""):
    """max|out - ref| <= bound * max|ref| (ref nonzero somewhere)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (where, out.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0, where
    err = np.abs(out - ref).max()
    assert err <= bound * scale, f"{where}: err {err:.3e} vs {bound} x {scale:.3e}"


def voxels():
    """Two scenes of unique voxels sorted by (batch, x, y, z), padding last,
    with 6 features each and a class per scene."""
    rng = np.random.RandomState(0)
    n = 420
    c = np.unique(np.stack([rng.randint(0, 2, n), rng.randint(0, SHAPE[0], n),
                            rng.randint(0, SHAPE[1], n), rng.randint(0, SHAPE[2], n)], 1),
                  axis=0).astype(np.int32)
    coords = np.concatenate([c, np.full((CAP - len(c), 4), -1, np.int32)])
    feat = (rng.randn(CAP, 6) * (coords[:, :1] >= 0)).astype(np.float32)
    return coords, feat, np.array([1, 3], np.int64)


def jax_cfg(cfg):
    cfg = dict(cfg)
    if "backbone" in cfg:
        cfg["backbone"] = jax_cfg(cfg["backbone"])
    else:
        cfg["remat"] = False
    return cfg


def random_variables(jmodel, args, seed=0):
    """The model's variables in the shapes of its init, drawn from a seed:
    kernels at 1/sqrt(fan-in), biases and BN scale / bias / statistics
    near their init values."""
    if isinstance(args[0], dict):
        args = ({**args[0], "spatial_shape": SHAPE, "batch_size": 2},)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *args, train=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        lo, hi = {"scale": (0.5, 1.5), "var": (0.5, 2.0)}.get(name, (-0.2, 0.2))
        return rng.uniform(lo, hi, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, {k: shapes[k] for k in
                                                   ("params", "batch_stats")})


def is_classifier(name):
    return CASES[name]["type"] == "DefaultClassifier"


def jax_inputs(classifier, coords, feat, category):
    if classifier:
        return ({"feat": jnp.asarray(feat), "grid_coord": jnp.asarray(coords[:, 1:]),
                 "batch": jnp.asarray(coords[:, 0]), "category": jnp.asarray(category)},)
    return (jmake(jnp.asarray(feat), jnp.asarray(coords), SHAPE, 2),)


def weights_of(name, out_shape, seed=1):
    """The fixed random weights of the training loss sum(out * R) / rows."""
    return np.random.RandomState(seed).randn(*out_shape).astype(np.float32)


def jax_run(name):
    """One case's JAX model variables, eval output, contract flag,
    training loss, grads and moved BN statistics (one jitted function), and
    the inputs they came from."""
    coords, feat, category = voxels()
    cfg = CASES[name]
    jmodel = jbuild(jax_cfg(cfg))
    args = jax_inputs(is_classifier(name), coords, feat, category)
    variables = random_variables(jmodel, args)
    classifier = is_classifier(name)

    def head(out):
        return out["cls_logits"] if classifier else out

    @jit
    def run(variables, args):
        if classifier:  # the batch's static ints, as the trainer adds them
            args = ({**args[0], "spatial_shape": SHAPE, "batch_size": 2},)
        ev, diag = jmodel.apply(variables, *args, train=False, mutable=["diagnostics"])

        def loss_fn(params):
            out, upd = jmodel.apply({"params": params,
                                     "batch_stats": variables["batch_stats"]},
                                    *args, train=True, mutable=["batch_stats"])
            if classifier:
                return out["loss"], upd
            r = jnp.asarray(weights_of(name, out.shape))
            return jnp.sum(out * r) / out.shape[0], upd

        (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        ok = jax.tree.leaves(diag.get("diagnostics", {}))
        return head(ev), (ok[0] if ok else jnp.asarray(True)), loss, grads, upd
    ev, ok, loss, grads, upd = jax.device_get(run(variables, args))
    return dict(name=name, variables=jax.device_get(variables), out=np.asarray(ev),
                ok=bool(ok), loss=float(loss), grads=grads, stats=upd["batch_stats"],
                coords=coords, feat=feat, category=category)


def to_port(name, params, stats):
    cfg = CASES[name]
    if is_classifier(name):
        return state_dict_from_jax_classifier({"params": params, "batch_stats": stats},
                                              cfg["backbone"])
    return state_dict_from_jax_backbone(params, stats, cfg)


def port_model(name, run):
    model = tbuild(dict(CASES[name]))
    sd = to_port(name, run["variables"]["params"], run["variables"]["batch_stats"])
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return model


def port_forward(model, coords, feat, category):
    if hasattr(model, "cls_head"):
        out = model({"feat": torch.from_numpy(feat),
                     "grid_coord": torch.from_numpy(coords[:, 1:]),
                     "batch": torch.from_numpy(coords[:, 0]), "spatial_shape": SHAPE,
                     "batch_size": 2, "category": torch.from_numpy(category)})
        return out["cls_logits"], out["contract_ok"], out.get("loss")
    st = tmake(torch.from_numpy(feat), torch.from_numpy(coords), SHAPE, 2)
    out, ok = model(st)
    return out, ok, None


def check_backbone_matches_jax(run):
    """Eval forward and a training loss with its grads and moved running
    statistics, within 1e-5 of max|ref|; ``contract_ok`` equal (and True).
    The body of ``test_backbone_matches_jax`` in
    ``test_torch_backbones_{mink,mink50,spunet,cls}.py``, one JAX model a
    module fixture there."""
    name = run["name"]
    coords, feat, category = run["coords"], run["feat"], run["category"]
    model = port_model(name, run).eval()
    with torch.no_grad():
        out, ok, _ = port_forward(model, coords, feat, category)
    assert bool(ok) == run["ok"] is True
    assert_rel(out.numpy(), run["out"], REL, f"{name} eval output")

    model.train()
    out, ok, loss = port_forward(model, coords, feat, category)
    if loss is None:
        r = torch.from_numpy(weights_of(name, tuple(out.shape)))
        loss = (out * r).sum() / out.shape[0]
    loss.backward()
    loss = float(loss.detach())
    assert bool(ok)
    assert abs(loss - run["loss"]) <= REL * abs(run["loss"]), (loss, run["loss"])
    ref = to_port(name, run["grads"], run["stats"])
    params = dict(model.named_parameters())
    for k, p in params.items():
        assert_rel(p.grad.numpy(), ref[k], REL, f"{name} grad {k}")
    for k, b in model.named_buffers():
        assert_rel(b.numpy(), ref[k], REL, f"{name} {k} after the training forward")
    routes = [m.last_route for m in model.modules() if isinstance(m, SubMConv)]
    assert any(r.startswith("band") for r in routes), routes


def test_mink_unet_plans_match_jax():
    """Each level's k3 rulebook, and the band plan of each level wider than
    64 channels (``attach_band_rulebook``), equal JAX's entry for entry; the
    strided plans' coords and packed pairing too."""
    coords = voxels()[0]
    jc, tc = jnp.asarray(coords), torch.from_numpy(coords)
    shape = SHAPE
    caps = (CAP, 1024, 1024, 1024, 1024)
    for level in range(1, 5):
        jp = jsp.build_strided_plan(jc, shape, 2, 2, 2, 0, caps[level])
        tp = tsp.build_strided_plan(tc, shape, 2, 2, 2, 0, caps[level])
        for field in ("out_coords", "rulebook", "parent", "tap"):
            np.testing.assert_array_equal(getattr(tp, field).numpy(),
                                          np.asarray(getattr(jp, field)), err_msg=field)
        jc, tc, shape = jp.out_coords, tp.out_coords, jp.spatial_shape
        jrb = jsp.attach_band_rulebook(jsp.build_subm_rulebook(jc, shape, 2, 3))
        trb = tsp.attach_band_rulebook(tsp.build_subm_rulebook(tc, shape, 2, 3))
        np.testing.assert_array_equal(trb.legacy.numpy(), np.asarray(jrb.legacy))
        for field in ("rbt", "w0", "ok", "ov_i", "ov_j", "ov_t"):
            np.testing.assert_array_equal(getattr(trb.band, field).numpy(),
                                          np.asarray(getattr(jrb.band, field)),
                                          err_msg=f"L{level} {field}")
        assert bool(trb.band.ok)
        assert tsp.plan_contract_flags(trb) == [trb.band.ok]


def test_mink_unet_routes_and_variants():
    """All 15 variants are registered with JAX's table; MinkUNet14A's convs
    take the routes JAX's rules give: the k5 stem and the narrow encoder
    levels plain, the 72-wide level and the decoder stage on its plan
    band-attached, the rest plain."""
    from ponderv2_tpu.models.sparse_unet import mink_unet as jmink

    assert _VARIANTS == jmink._VARIANTS and len(_VARIANTS) == 15
    assert all(name in TMODELS for name in _VARIANTS)
    coords, feat, _ = voxels()
    model = tbuild(dict(CASES["MinkUNet14A"])).eval()
    with torch.no_grad():
        port_forward(model, coords, feat, None)
    routes = [(m.in_channels, m.last_route) for m in model.modules()
              if isinstance(m, SubMConv)]
    band = [r for r in routes if r[1].startswith("band")]
    # block2: one block's 2 convs at 72; block3 (the decoder at L1): one block
    assert band == [(72, "band-attached")] * 2 + [(88, "band-attached"), (72, "band-attached")], \
        routes
    assert routes[0] == (6, "plain") and len(routes) == 1 + 2 + 4 + 2


def test_classifier_pools_per_voxel_rows():
    """Over a backbone that returns per-voxel rows, DefaultClassifier's
    logits are ``cls_head`` of each scene's mean over its valid rows."""
    coords, feat, category = voxels()
    backbone = dict(type="SpUNet-v1m1", num_classes=0, **SPUNET)
    clf = tbuild(dict(type="DefaultClassifier", num_classes=4, criteria=CE,
                      backbone_embed_dim=SPUNET["channels"][-1], backbone=backbone)).eval()
    with torch.no_grad():
        logits, ok, _ = port_forward(clf, coords, feat, category)
        st = tmake(torch.from_numpy(feat), torch.from_numpy(coords), SHAPE, 2)
        rows, _ = clf.backbone(st)
    rows = rows.numpy().astype(np.float64)
    pooled = np.stack([rows[coords[:, 0] == b].mean(0) for b in range(2)])
    w, bias = clf.cls_head.weight.detach().numpy(), clf.cls_head.bias.detach().numpy()
    assert bool(ok)
    assert_rel(logits.numpy(), pooled @ w.T + bias, REL, "pooled logits")


def test_cls_mode_without_final_port_only():
    """With ``num_classes=0`` the ``cls_mode`` backbone has no ``final`` and
    gives the pooled (B, channels[num_stages - 1]) features; DefaultClassifier's loss
    reaches the encoder's weights. JAX fault F12: the JAX model builds its
    ``final`` Dense there and fails at init (ZeroDivisionError)."""
    coords, feat, category = voxels()
    cfg = dict(type="SpUNet-v1m1", num_classes=0, cls_mode=True, **SPUNET)
    with pytest.raises(ZeroDivisionError):
        random_variables(jbuild(jax_cfg(cfg)), jax_inputs(False, coords, feat, category))
    backbone = tbuild(dict(cfg))
    assert backbone.final is None and not hasattr(backbone, "dec")
    st = tmake(torch.from_numpy(feat), torch.from_numpy(coords), SHAPE, 2)
    with torch.no_grad():
        pooled, ok = backbone.eval()(st)
    assert pooled.shape == (2, SPUNET["channels"][1]) and bool(ok)
    clf = tbuild(dict(type="DefaultClassifier", num_classes=4, criteria=CE,
                      backbone_embed_dim=SPUNET["channels"][1], backbone=cfg)).train()
    out, ok, loss = port_forward(clf, coords, feat, category)
    loss.backward()
    assert out.shape == (2, 4) and bool(ok) and bool(torch.isfinite(loss))
    for name, p in clf.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    assert float(clf.backbone.enc[1].block0.conv2.weight.grad.abs().max()) > 0
    assert float(clf.backbone.conv_input[0].weight.grad.abs().max()) > 0


def test_spunet_v1m2_is_v1m1():
    """SpUNet-v1m2 is registered as v1m1 under another name, in both."""
    from ponderv2_tpu.models import MODELS as JMODELS

    cfg = dict(num_classes=5, **SPUNET)
    a, b = tbuild(dict(type="SpUNet-v1m1", **cfg)), tbuild(dict(type="SpUNet-v1m2", **cfg))
    assert TMODELS.get("SpUNet-v1m2") is TMODELS.get("SpUNet-v1m1")
    assert list(a.state_dict()) == list(b.state_dict())
    assert issubclass(JMODELS.get("SpUNet-v1m2"), JMODELS.get("SpUNet-v1m1"))
