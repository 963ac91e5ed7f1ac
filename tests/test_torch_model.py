"""Model-level parity of the PyTorch port with the JAX package on the CPU,
with the flax parameters carried across by ``weights.from_flax``.

* the stride-2 transposed conv and the NHWC flatten feeding the FC heads;
* a VGG-pyramid branch (space-to-depth, decode_stride 2);
* the slice: ``forward_batch_fn`` + ``decode_batch`` on a narrow cars-preset
  config that keeps every main-path branch on (packed voxelizer, quad
  filter, strided grouped RPN crops with projections, SHPL pool projections,
  exact stage-2 crops, flip head, eval_nms_size).

Tolerances: 1e-5 on single layers, 1e-4 on conv stacks and heads (f32 sums
of a few hundred products in other orders); detection indices and validity
must be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
nn = pytest.importorskip("flax.linen")

from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.models import backbone as j_backbone  # noqa: E402
from sparse_pooling_tpu.models import detector as j_det  # noqa: E402
from sparse_pooling_tpu.models import pipeline as j_pl  # noqa: E402
from sparse_pooling_tpu_torch import weights  # noqa: E402
from sparse_pooling_tpu_torch.configs import cars_pyramid_config  # noqa: E402
from sparse_pooling_tpu_torch.configs import config as tcfg_mod  # noqa: E402
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame  # noqa: E402
from sparse_pooling_tpu_torch.models import backbone as t_backbone  # noqa: E402
from sparse_pooling_tpu_torch.models import detector as t_det  # noqa: E402
from sparse_pooling_tpu_torch.models import pipeline as t_pl  # noqa: E402
from sparse_pooling_tpu_torch.models.layers import ConvTransposeSame  # noqa: E402


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _to_jax_model_cfg(cfg):
    return jcfg_mod.pipeline_config_from_dict({"model": dataclasses.asdict(cfg)}).model


def _load(module, sd, prefix=""):
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    module.load_state_dict(sub, strict=True)


@pytest.mark.parametrize("hw", [(5, 7), (4, 6), (1, 1)])
def test_conv_transpose_matches_flax(hw):
    rng = np.random.RandomState(hw[0])
    x = rng.randn(2, *hw, 3).astype(np.float32)
    layer = nn.ConvTranspose(4, (3, 3), strides=(2, 2), padding="SAME")
    params = layer.init(jax.random.PRNGKey(1), jnp.array(x))
    want = np.asarray(layer.apply(params, jnp.array(x)))
    cfg = tcfg_mod.ModelConfig(backbone=tcfg_mod.BackboneConfig(decode_stride=1))
    sd = weights.from_flax({"upconv3": _np_tree(params)["params"]}, cfg)
    t = ConvTransposeSame(3, 4)
    _load(t, sd, "upconv3.")
    got = t(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 4)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_rpn_head_flatten_matches_flax():
    """fc1 sees ROI features flattened in NHWC (S, S, C) order on both sides."""

    rng = np.random.RandomState(2)
    rois = rng.randn(2, 6, 3, 3, 4).astype(np.float32)
    head = j_det.RpnHead(16, jnp.float32)
    params = head.init(jax.random.PRNGKey(0), jnp.array(rois))
    want = head.apply(params, jnp.array(rois))
    t = t_det.RpnHead(36, 16, torch.float32)
    _load(t, weights.from_flax(_np_tree(params), tcfg_mod.ModelConfig()))
    got = t(torch.from_numpy(rois))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("pre_packed", [False, True])
def test_pyramid_extractor_matches_flax(pre_packed):
    channels, blocks = (4, 8, 8, 16), (1, 2, 1, 1)
    rng = np.random.RandomState(7)
    cin = 6
    x = rng.rand(2, 32, 48, 4 * cin if pre_packed else cin).astype(np.float32)
    jm = j_backbone.VggPyramidExtractor(
        channels, blocks, 8, jnp.float32, decode_stride=2, space_to_depth=True
    )

    def run(m, inp):
        mid, skips = m.encode(inp, pre_packed)
        return mid, m.decode(mid, skips)

    params = jm.init(jax.random.PRNGKey(3), jnp.array(x), method=run)
    mid, want = jm.apply(params, jnp.array(x), method=run)
    cfg = tcfg_mod.ModelConfig(
        backbone=tcfg_mod.BackboneConfig(channels=channels, blocks=blocks, decode_stride=2)
    )
    tm = t_backbone.VggPyramidExtractor(cin, channels, blocks, 8, torch.float32, 2, True)
    _load(tm, weights.from_flax(_np_tree(params), cfg))
    with torch.no_grad():
        tmid, tskips = tm.encode(torch.from_numpy(x), pre_packed)
        got = tm.decode(tmid, tskips).numpy()
    np.testing.assert_allclose(tmid.numpy(), np.asarray(mid), atol=1e-4)
    assert got.shape == want.shape == ((2, 32, 48, 8) if pre_packed else (2, 16, 24, 8))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------- the slice

T_EXT = tcfg_mod.AreaExtents(x_min=-8.0, x_max=8.0, z_min=0.0, z_max=12.4)


def parity_config():
    """cars_pyramid_config() narrowed for the CPU: f32, thin widths, a
    reduced extent (above), 1024 points; every main-path branch stays on."""

    cfg = cars_pyramid_config().model
    r = dataclasses.replace
    return r(
        cfg,
        image=r(cfg.image, height=64, width=192),
        sparse_pool=r(cfg.sparse_pool, max_points=1024, pool_channels=4),
        anchors=r(cfg.anchors, max_anchors=512),
        backbone=r(cfg.backbone, channels=(4, 8, 8, 8), blocks=(1, 1, 1, 1),
                   out_channels=8, compute_dtype="float32"),
        rpn=r(cfg.rpn, roi_channels=4, fusion_channels=32, pre_nms_top_k=256, eval_nms_size=32),
        avod=r(cfg.avod, fc_layers=(32, 32, 32), nms_size=16),
    )


@pytest.fixture(scope="module")
def slice_run():
    cfg = parity_config()
    c = cfg
    assert c.backbone.space_to_depth and c.backbone.decode_stride == 2 and c.rpn.roi_quad == 4
    assert c.rpn.bev_roi_stride == 8 and c.rpn.img_roi_stride == 4 and c.avod.explicit_flip_head
    assert c.avod.bev_roi_stride == c.avod.img_roi_stride == 1
    frames = [synthetic_frame(cfg, n_points=1024, seed=s, image="noise") for s in (0, 1)]

    jcfg = _to_jax_model_cfg(cfg)
    jext = jcfg_mod.AreaExtents(**dataclasses.asdict(T_EXT))
    jmodel = j_pl.make_model(jcfg, jext)
    janchors = jnp.array(j_pl.static_anchor_grid(jcfg, jext))
    jbatch = j_pl.RawSample(**{
        k: jnp.array(np.stack([f[k] for f in frames])) for k in j_pl.RawSample._fields
    })

    def init(key, batch):  # jitted: eager tracing of the whole model is ~5x slower
        raw0 = jax.tree.map(lambda x: x[0], batch)
        inputs = j_pl.build_model_inputs(raw0, janchors, jnp.ones((2,), jnp.float32), jcfg, jext)
        return jmodel.init({"params": key, "dropout": key}, inputs, train=False)

    def forward(params, batch):
        out = j_pl.forward_batch_fn(jmodel, params, batch, janchors, jcfg, jext, False)
        return out, j_pl.decode_batch(out, batch.ground_plane, jcfg, jext)

    params = jax.jit(init)(jax.random.PRNGKey(0), jbatch)
    jout, jdet = jax.jit(forward)(params, jbatch)

    tmodel = t_pl.make_model(cfg, T_EXT, device="cpu")
    tmodel.load_state_dict(weights.from_flax(_np_tree(params), cfg), strict=True)
    tbatch = t_pl.stack_frames(frames, device="cpu")
    tanchors = t_pl.static_anchor_grid(cfg, T_EXT, device="cpu")
    tout = t_pl.forward_batch_fn(tmodel, tbatch, tanchors, cfg, T_EXT)
    tdet = t_pl.decode_batch(tout, tbatch.ground_plane, cfg, T_EXT)
    return jout, jdet, tout, tdet


_FLOAT_OUTPUTS = ("objectness", "rpn_offsets", "anchors", "proposals", "proposal_scores",
                  "cls_logits", "box_offsets", "orientation", "flip_logits")


@pytest.mark.parametrize("key", _FLOAT_OUTPUTS)
def test_slice_outputs_match_jax(slice_run, key):
    jout, _, tout, _ = slice_run
    np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=1e-4)


@pytest.mark.parametrize("key", ["anchor_valid", "proposal_valid"])
def test_slice_masks_match_jax(slice_run, key):
    jout, _, tout, _ = slice_run
    np.testing.assert_array_equal(tout[key].numpy(), np.asarray(jout[key]))
    assert tout[key].any()


@pytest.mark.parametrize("flip_head", [True, False])
def test_decode_detections_matches_jax(flip_head):
    """Both heading rules: the flip head's logits, or the angle vector."""

    cfg = cars_pyramid_config().model
    cfg = dataclasses.replace(
        cfg, avod=dataclasses.replace(cfg.avod, explicit_flip_head=flip_head, nms_size=36)
    )
    rng = np.random.RandomState(int(flip_head))
    b, p = 2, 40
    proposals = np.concatenate([
        rng.uniform(-20, 20, (b, p, 1)), np.full((b, p, 1), 1.6), rng.uniform(5, 60, (b, p, 1)),
        np.array([3.9, 1.6, 1.5]) + rng.uniform(-0.3, 0.3, (b, p, 3)),
    ], -1).astype(np.float32)
    proposals[:, p // 2:] = proposals[:, :p // 2] + rng.normal(0, 0.3, (b, p // 2, 6))  # overlaps
    outputs = {
        "proposals": proposals,
        "box_offsets": rng.normal(0, 0.05, (b, p, 10)).astype(np.float32),
        "orientation": rng.normal(0, 1, (b, p, 2)).astype(np.float32),
        "cls_logits": rng.normal(0, 1, (b, p, 2)).astype(np.float32),
        "proposal_valid": rng.rand(b, p) < 0.8,
    }
    if flip_head:
        outputs["flip_logits"] = rng.normal(0, 1, (b, p, 2)).astype(np.float32)
    plane = np.array([[0.0, -1.0, 0.0, 1.65], [0.01, -1.0, 0.02, 1.6]], np.float32)
    jext = jcfg_mod.AreaExtents()
    want = j_det.decode_detections(
        {k: jnp.array(v) for k, v in outputs.items()}, jnp.array(plane), _to_jax_model_cfg(cfg), jext
    )
    got = t_det.decode_detections(
        {k: torch.from_numpy(v) for k, v in outputs.items()}, torch.from_numpy(plane), cfg,
        tcfg_mod.AreaExtents(),
    )
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].any() and not got["valid"].all()
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-6)
    np.testing.assert_allclose(got["boxes_3d"].numpy(), np.asarray(want["boxes_3d"]), atol=1e-4)


def test_slice_detections_match_jax(slice_run):
    _, jdet, _, tdet = slice_run
    np.testing.assert_array_equal(tdet["valid"].numpy(), np.asarray(jdet["valid"]))
    assert tdet["valid"].any()
    np.testing.assert_allclose(tdet["scores"].numpy(), np.asarray(jdet["scores"]), atol=1e-5)
    np.testing.assert_allclose(tdet["boxes_3d"].numpy(), np.asarray(jdet["boxes_3d"]), atol=1e-4)
