"""The AVOD detector's RPN options, PyTorch port against the JAX package on
the CPU: the dense-grid RPN at a group that divides the anchor grid and at
one that does not, and reference-exact (stride-1) RPN crops with the
unpacked voxelizer and full-resolution decoders.

Each option turns one switch of the narrow parity config of
``tests/test_torch_model.py`` (f32, thin widths; path drop off, dropout's
keep probability 1, every anchor into the RPN's NMS and 256 proposals out of
it in training so the stage-2 minibatch holds positives). Two frames go
through both packages with the JAX init carried over by
``weights.from_flax``: every forward output per anchor and per proposal to
1e-4 of its largest value (f32 sums of a few hundred products in other
orders), masks equal, the detections of ``decode_batch``; one training
step's loss terms to 1e-4 and every parameter's gradient to 1e-4 of that
parameter's largest, the sampling noise drawn from JAX's keys.

The dense grid's block permutation is held per anchor: its BEV ROIs come
from windows shared by GxG neighbour positions, permuted block-major for the
crop and back, and a wrong permutation would move objectness and offsets to
other anchors. The grids are not square (24 x 32 positions at group 4; 26 x
38 at a configured 4 that runs at 2, ``largest_group_divisor``).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
pytest.importorskip("flax")  # the JAX package imports flax

from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.models import detector as j_det  # noqa: E402
from sparse_pooling_tpu.models import pipeline as j_pl  # noqa: E402
from sparse_pooling_tpu_torch import weights  # noqa: E402
from sparse_pooling_tpu_torch.configs import config as tcfg_mod  # noqa: E402
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame  # noqa: E402
from sparse_pooling_tpu_torch.models import detector as t_det  # noqa: E402
from sparse_pooling_tpu_torch.models import pipeline as t_pl  # noqa: E402
from sparse_pooling_tpu_torch.ops import anchors as t_anchors  # noqa: E402
from test_torch_model import parity_config  # noqa: E402
from test_torch_train import _loss_noise, gt_on_cluster  # noqa: E402

TOL = 1e-4  # relative to the largest value
r = dataclasses.replace
T_EXT = tcfg_mod.AreaExtents(x_min=-8.0, x_max=8.0, z_min=0.0, z_max=12.4)
# 24 x 32 anchor positions (group 4 divides both), and 26 x 38 (it runs at 2)
EXT_G4 = tcfg_mod.AreaExtents(x_min=-8.0, x_max=8.0, z_min=0.0, z_max=12.0)
EXT_G2 = tcfg_mod.AreaExtents(x_min=-9.6, x_max=9.6, z_min=0.0, z_max=13.2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_cfg(model_cfg):
    return jcfg_mod.pipeline_config_from_dict({"model": dataclasses.asdict(model_cfg)}).model


def _close(got, want, what, tol=TOL, floor=1.0):
    """Max abs error within ``tol`` of max(|want|, ``floor``)."""

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    scale = max(np.abs(want).max(initial=0.0), floor)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol:g} * {scale:.3g}"


def option_config(ext, **switches):
    """The narrow parity config in training form, then ``switches``
    ({section: {field: value}}); every anchor enters the RPN's NMS."""

    cfg = parity_config()
    cfg = r(
        cfg,
        rpn=r(cfg.rpn, train_nms_size=256),
        avod=r(cfg.avod, keep_dropout_prob=1.0),
        path_drop=r(cfg.path_drop, enabled=False),
    )
    for section, fields in switches.items():
        cfg = r(cfg, **{section: r(getattr(cfg, section), **fields)})
    nz, nx = t_anchors.grid_shape(cfg.anchors, ext)
    n = nz * nx * 2 if cfg.rpn.dense_grid else cfg.anchors.max_anchors
    return r(cfg, rpn=r(cfg.rpn, pre_nms_top_k=n))


def option_frames(cfg, ext, seeds=(2, 3), n_points=1024):
    return [gt_on_cluster(synthetic_frame(cfg, n_points=n_points, seed=s, image="noise"), ext)
            for s in seeds]


def jax_run(cfg, ext, frames, init_seed=0, loss_seed=11):
    """The JAX package on ``frames``: its init (numpy), serving outputs and
    detections, one training step's loss terms and gradients (as a port
    state dict) and the port's sampling noise from the same key."""

    jcfg = _jax_cfg(cfg)
    jext = jcfg_mod.AreaExtents(**dataclasses.asdict(ext))
    jmodel = j_pl.make_model(jcfg, jext)
    janchors = jnp.array(j_pl.static_anchor_grid(jcfg, jext))
    jbatch = j_pl.RawSample(**{k: jnp.array(np.stack([f[k] for f in frames])) for k in j_pl.RawSample._fields})

    def init(key, batch):  # jitted: eager tracing of the whole model is ~5x slower
        raw0 = jax.tree.map(lambda x: x[0], batch)
        inputs = j_pl.build_model_inputs(raw0, janchors, jnp.ones((2,), jnp.float32), jcfg, jext)
        return jmodel.init({"params": key, "dropout": key}, inputs, train=False)

    def serve(params, batch):
        out = j_pl.forward_batch_fn(jmodel, params, batch, janchors, jcfg, jext, False)
        return out, j_pl.decode_batch(out, batch.ground_plane, jcfg, jext)

    def loss_fn(params, batch, key):  # the reference train step's loss_fn
        r_fwd, r_loss = jax.random.split(key)
        out = j_pl.forward_batch_fn(jmodel, params, batch, janchors, jcfg, jext, True, r_fwd)
        losses = j_pl.loss_batch(out, batch, r_loss, jcfg, jext)
        return losses["total"], (losses, out["anchors"].shape[1], out["proposals"].shape[1])

    params = jax.jit(init)(jax.random.PRNGKey(init_seed), jbatch)
    run = {"params": _np_tree(params)}
    run["out"], run["det"] = jax.jit(serve)(params, jbatch)
    key = jax.random.PRNGKey(loss_seed)
    (_, (losses, a, p)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, jbatch, key)
    run.update(losses=losses, grads=weights.from_flax(_np_tree(grads), cfg),
               noise=_loss_noise(jax.random.split(key)[1], len(frames), a, p))
    return run


def port_run(cfg, ext, frames, params, noise):
    """The port on ``frames`` with the JAX init: serving outputs and
    detections, one training step's loss terms and every parameter's
    gradient."""

    model = t_pl.make_model(cfg, ext, device="cpu")
    model.load_state_dict(weights.from_flax(params, cfg), strict=True)
    batch = t_pl.stack_frames(frames, device="cpu")
    anchors = t_pl.static_anchor_grid(cfg, ext, device="cpu")
    out = t_pl.forward_batch_fn(model, batch, anchors, cfg, ext)
    run = {"model": model, "out": out, "det": t_pl.decode_batch(out, batch.ground_plane, cfg, ext)}
    model.float()
    losses = t_pl.loss_batch(t_pl.forward_batch_fn(model, batch, anchors, cfg, ext, train=True),
                             batch, cfg, ext, noise=noise)
    losses["total"].backward()
    run.update(losses=losses, grads={n: prm.grad for n, prm in model.named_parameters()})
    return run


def both(cfg, ext, init_seed=0, frames=None):
    frames = option_frames(cfg, ext) if frames is None else frames
    j = jax_run(cfg, ext, frames, init_seed=init_seed)
    return {"cfg": cfg, "ext": ext, "jax": j, "port": port_run(cfg, ext, frames, j["params"], j["noise"])}


FLOAT_OUTPUTS = ("objectness", "rpn_offsets", "anchors", "proposals", "proposal_scores",
                 "cls_logits", "box_offsets", "orientation", "flip_logits")
TERMS = ("total", "rpn_objectness", "rpn_regression", "cls", "reg", "orientation", "flip",
         "num_rpn_pos", "num_s2_pos")


def check_outputs(run, key):
    got, want = run["port"]["out"][key], run["jax"]["out"][key]
    _close(got.numpy(), want, key)


def check_masks(run, key):
    got = run["port"]["out"][key].numpy()
    np.testing.assert_array_equal(got, np.asarray(run["jax"]["out"][key]))
    assert got.any()


def check_detections(run):
    got, want = run["port"]["det"], run["jax"]["det"]
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].any()
    _close(got["scores"].numpy(), want["scores"], "scores")
    _close(got["boxes_3d"].numpy(), want["boxes_3d"], "boxes_3d")


def check_loss(run, term, positives=("num_rpn_pos", "num_s2_pos", "rpn_regression", "reg")):
    got, want = run["port"]["losses"][term].item(), float(run["jax"]["losses"][term])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    if term in positives:
        assert got > 0  # the minibatches hold positives


def check_gradients(run):
    jg, tg = run["jax"]["grads"], run["port"]["grads"]
    assert set(jg) == set(tg)
    for name, want in jg.items():
        got = tg[name]
        assert got is not None and torch.isfinite(got).all(), name
        scale = max(want.abs().max().item(), 1e-8)
        err = (got - want).abs().max().item()
        assert err <= TOL * scale, f"{name}: max abs err {err:.3e} > {TOL:g} * {scale:.3e}"
    for name in ("bev_extractor.encoder.conv1_1.weight", "rpn_head.fc1.weight"):
        assert tg[name].abs().max() > 0, name


# ---------------------------------------------------------------- the options

OPTIONS = {
    "dense_grid_g4": (dict(rpn=dict(dense_grid=True), bev=dict(pad_h=0)), EXT_G4),
    "dense_grid_g2": (dict(rpn=dict(dense_grid=True)), EXT_G2),
    "exact_rpn_crops": (dict(rpn=dict(bev_roi_stride=1, img_roi_stride=1, roi_quad=1),
                             backbone=dict(decode_stride=1, space_to_depth=False)), T_EXT),
}


@pytest.fixture(scope="module", params=list(OPTIONS))
def option_run(request):
    switches, ext = OPTIONS[request.param]
    return both(option_config(ext, **switches), ext)


@pytest.mark.parametrize("key", FLOAT_OUTPUTS)
def test_forward_outputs_match_jax(option_run, key):
    check_outputs(option_run, key)


@pytest.mark.parametrize("key", ["anchor_valid", "proposal_valid"])
def test_forward_masks_match_jax(option_run, key):
    check_masks(option_run, key)


def test_detections_match_jax(option_run):
    check_detections(option_run)


@pytest.mark.parametrize("term", TERMS)
def test_train_step_losses_match_jax(option_run, term):
    check_loss(option_run, term)


def test_train_step_gradients_match_jax(option_run):
    check_gradients(option_run)


def test_option_shapes(option_run):
    """What each option is: the dense grid scores every anchor (no cap) and
    runs at the largest dividing group; exact crops build no projection and
    read the unpacked raster."""

    cfg, ext, model = option_run["cfg"], option_run["ext"], option_run["port"]["model"]
    nz, nx = t_anchors.grid_shape(cfg.anchors, ext)
    a = option_run["port"]["out"]["anchors"].shape[1]
    if cfg.rpn.dense_grid:
        assert a == nz * nx * 2 and nz != nx
        assert model.bev_group == t_det.largest_group_divisor(nz, nx, 4) == (4 if nz == 24 else 2)
        assert model.bev_group == j_det.largest_group_divisor(nz, nx, 4)
    else:
        assert a == cfg.anchors.max_anchors
        assert not hasattr(model, "bev_roi_proj") and not hasattr(model, "img_roi_proj")
        inputs = t_pl.build_model_inputs_batch(
            t_pl.stack_frames(option_frames(cfg, ext), device="cpu"),
            t_pl.static_anchor_grid(cfg, ext, device="cpu"), torch.ones(2, 2), cfg, ext)
        h, w = cfg.bev.padded_hw(ext)
        assert not inputs["bev_pre_packed"] and inputs["bev_input"].shape == (2, h, w, 6)


def test_largest_group_divisor_matches_jax():
    for nz, nx, g in ((6, 6, 4), (24, 32, 4), (26, 38, 4), (7, 11, 4), (140, 160, 4), (9, 12, 8)):
        assert t_det.largest_group_divisor(nz, nx, g) == j_det.largest_group_divisor(nz, nx, g)
    assert t_det.largest_group_divisor(6, 6, 4) == 3


def _jax_raises(case):
    """The exception type the JAX package raises for ``case``."""

    from sparse_pooling_tpu.models import backbone as j_backbone

    avod = _jax_cfg(option_config(T_EXT))
    jext = jcfg_mod.AreaExtents(**dataclasses.asdict(T_EXT))
    try:
        if case == "s2d_at_decode_stride_1":
            m = j_backbone.VggPyramidExtractor((4, 8), (1, 1), 8, jnp.float32, decode_stride=1,
                                               space_to_depth=True)
            m.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 6)))
        else:  # make_model checks, then the detector's setup does
            j_pl.make_model(_JAX_BAD[case](avod), jext).bind({}).rpn_head
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e)
    return None


_JAX_BAD = {
    "one_view_projected": lambda c: r(c, rpn=r(c.rpn, bev_roi_stride=1)),
    "offsets_box_rep": lambda c: r(c, avod=r(c.avod, box_rep="offsets")),
    "unknown_architecture": lambda c: r(c, architecture="mv3d"),
}
_PORT_BAD = {
    "s2d_at_decode_stride_1": lambda c: r(c, backbone=r(c.backbone, decode_stride=1), rpn=r(
        c.rpn, bev_roi_stride=1, img_roi_stride=1)),
    **_JAX_BAD,
}


@pytest.mark.parametrize("case", list(_PORT_BAD))
def test_rejected_combinations_raise_as_in_jax(case):
    """What the JAX package refuses, the port refuses with the same exception
    type: ``space_to_depth`` at ``decode_stride`` 1, ``roi_channels`` with one
    view strided, ``box_rep="offsets"`` on the AVOD detector, an unknown
    architecture."""

    want = _jax_raises(case)
    assert want is not None
    with pytest.raises(want):
        t_pl.make_model(_PORT_BAD[case](option_config(T_EXT)), T_EXT, device="cpu")
