"""The rcnn family (``FusionRcnn``, the ``rcnn_cars`` preset) and box_8c of
the PyTorch port against the JAX package on the CPU.

Seeded numpy inputs go through both packages; the port runs with
``device="cpu"`` (the kernels' plain twins), the JAX model with its own init
carried over by ``weights.from_flax``. Where JAX draws random numbers (the
minibatch priorities) the port gets the same draws from JAX's keys.

* ``rcnn_anchor_grid`` bit for bit, at the narrow config and at full width;
* the narrow config of ``tests/test_torch_model.py`` as the rcnn family
  (f32, two frames, ``train_nms_size`` = ``pre_nms_top_k`` = every anchor,
  so the stage-2 minibatch holds positives), once per stage-2 encoding
  (6-d offsets, box_4c, box_8c): every ``FusionRcnn`` output to 1e-4 of its
  largest value, masks and indices equal; the detections (``decode_batch``);
  one training step's loss terms to 1e-4 and every parameter's gradient to
  1e-4 of its largest (the proposals keep their gradient into stage 2: the
  exact crop's box gradient and the regression targets);
* ``decode_rcnn_detections`` on fixed outputs, with and without the flip
  head, to 1e-4 (boxes) and 1e-6 (scores), validity equal;
* box_8c: the three encoders to 1e-5; ``decode_detections``, and the AVOD
  detector's detections and training step (losses, gradients) as above,
  with the proposals detached and, with ``avod.stop_gradient_proposals``
  off, keeping their gradient;
* the exact crop's box gradient against ``jax.vjp`` of the reference crop;
* the people preset's serving path and one training step (a pedestrian and
  a cyclist), narrowed (two classes, a 0.3 m anchor stride, 4x4-position
  blocks of 64 anchors over a 41x53 grid that pads), and its
  ``KittiDataset`` (class map) over the JAX writer's people scenes;
* ``Trainer`` then ``Evaluator`` on the port over a tree from the JAX
  package's ``write_kitti_tree`` with ``rcnn_cars`` narrowed, against the
  JAX ``Evaluator`` on the same weights: rows within the tolerances of
  tests/test_torch_eval.py (1e-3 px, 1e-4), AP within 1e-6; the three CLIs.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
pytest.importorskip("flax")  # the JAX package imports flax

from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.data import synthetic as j_syn  # noqa: E402
from sparse_pooling_tpu.models import detector as j_det  # noqa: E402
from sparse_pooling_tpu.models import fusion_rcnn as j_fr  # noqa: E402
from sparse_pooling_tpu.models import pipeline as j_pl  # noqa: E402
from sparse_pooling_tpu.ops import crop_resize as j_crop  # noqa: E402
from sparse_pooling_tpu.ops import encoders as j_enc  # noqa: E402
from sparse_pooling_tpu.runtime import evaluator as j_evaluator  # noqa: E402
from sparse_pooling_tpu_torch import weights  # noqa: E402
from sparse_pooling_tpu_torch.configs import cars_pyramid_config  # noqa: E402
from sparse_pooling_tpu_torch.configs import config as tcfg_mod  # noqa: E402
from sparse_pooling_tpu_torch.configs.presets import people_pyramid_config, rcnn_cars_config  # noqa: E402
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame  # noqa: E402
from sparse_pooling_tpu_torch.models import detector as t_det  # noqa: E402
from sparse_pooling_tpu_torch.models import fusion_rcnn as t_fr  # noqa: E402
from sparse_pooling_tpu_torch.models import pipeline as t_pl  # noqa: E402
from sparse_pooling_tpu_torch.ops import crop_resize as t_crop  # noqa: E402
from sparse_pooling_tpu_torch.ops import encoders as t_enc  # noqa: E402
from sparse_pooling_tpu_torch.runtime import checkpoint as ckpt_mod  # noqa: E402
from sparse_pooling_tpu_torch.runtime.evaluator import Evaluator  # noqa: E402
from sparse_pooling_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from test_torch_train import _frames, _loss_noise  # noqa: E402

T_EXT = tcfg_mod.AreaExtents(x_min=-8.0, x_max=8.0, z_min=0.0, z_max=12.4)
J_EXT = jcfg_mod.AreaExtents(**dataclasses.asdict(T_EXT))
TOL = 1e-4  # relative to the largest value (f32 sums in other orders)
r = dataclasses.replace


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_cfg(model_cfg):
    return jcfg_mod.pipeline_config_from_dict({"model": dataclasses.asdict(model_cfg)}).model


def _close(got, want, what, tol=TOL, floor=1.0):
    """Max abs error within ``tol`` of max(|want|, ``floor``)."""

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(initial=0.0), floor)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol:g} * {scale:.3g}"


def _box3d(rng, n):
    return np.stack([
        rng.uniform(-6, 6, n), rng.uniform(1.4, 1.9, n), rng.uniform(2, 11, n),
        rng.uniform(3.2, 4.6, n), rng.uniform(1.4, 1.9, n), rng.uniform(1.3, 1.7, n),
        rng.uniform(-np.pi, np.pi, n),
    ], -1).astype(np.float32)


def _jax_run(cfg, frames, init_seed, loss_seed=None):
    """The JAX package on ``frames``: its init (as a dict of numpy arrays),
    serving outputs and detections, and with ``loss_seed`` one training
    step's loss terms, gradients and the port's sampling noise drawn from
    the same key."""

    jcfg = _jax_cfg(cfg)
    jmodel = j_pl.make_model(jcfg, J_EXT)
    janchors = jnp.array(j_pl.static_anchor_grid(jcfg, J_EXT))
    jbatch = j_pl.RawSample(**{k: jnp.array(np.stack([f[k] for f in frames])) for k in j_pl.RawSample._fields})

    def init(key, batch):  # jitted: eager tracing of the whole model is ~5x slower
        raw0 = jax.tree.map(lambda x: x[0], batch)
        inputs = j_pl.build_model_inputs(raw0, janchors, jnp.ones((2,), jnp.float32), jcfg, J_EXT)
        return jmodel.init({"params": key, "dropout": key}, inputs, train=False)

    def serve(params, batch):
        out = j_pl.forward_batch_fn(jmodel, params, batch, janchors, jcfg, J_EXT, False)
        return out, j_pl.decode_batch(out, batch.ground_plane, jcfg, J_EXT)

    def loss_fn(params, batch, key):  # the reference train step's loss_fn
        r_fwd, r_loss = jax.random.split(key)
        out = j_pl.forward_batch_fn(jmodel, params, batch, janchors, jcfg, J_EXT, True, r_fwd)
        losses = j_pl.loss_batch(out, batch, r_loss, jcfg, J_EXT)
        return losses["total"], (losses, out["anchors"].shape[1], out["proposals"].shape[1])

    params = jax.jit(init)(jax.random.PRNGKey(init_seed), jbatch)
    run = {"params": _np_tree(params)}
    run["out"], run["det"] = jax.jit(serve)(params, jbatch)
    if loss_seed is not None:
        key = jax.random.PRNGKey(loss_seed)
        (_, (losses, a, p)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, jbatch, key)
        run.update(losses=losses, grads=weights.from_flax(_np_tree(grads), cfg),
                   noise=_loss_noise(jax.random.split(key)[1], len(frames), a, p))
    return run


def _port_step(cfg, frames, params, noise):
    """The port on ``frames`` with the JAX init: serving outputs, detections,
    one training step's loss terms and every parameter's gradient."""

    model = t_pl.make_model(cfg, T_EXT, device="cpu")
    model.load_state_dict(weights.from_flax(params, cfg), strict=True)
    batch = t_pl.stack_frames(frames, device="cpu")
    anchors = t_pl.static_anchor_grid(cfg, T_EXT, device="cpu")
    out = t_pl.forward_batch_fn(model, batch, anchors, cfg, T_EXT)
    run = {"model": model, "out": out, "det": t_pl.decode_batch(out, batch.ground_plane, cfg, T_EXT)}
    if noise is not None:
        losses = t_pl.loss_batch(t_pl.forward_batch_fn(model, batch, anchors, cfg, T_EXT, train=True),
                                 batch, cfg, T_EXT, noise=noise)
        losses["total"].backward()
        run.update(losses=losses, grads={n: prm.grad for n, prm in model.named_parameters()})
    return run


# ---------------------------------------------------------------- anchors

def rcnn_parity_config(box_rep="offsets"):
    """``rcnn_cars_config()`` at the narrow widths of tests/test_torch_model.py
    (f32; a 16x20 fusion lattice over ``T_EXT``, 640 anchors), every anchor
    through the RPN's NMS and up to 640 proposals out of it in training,
    path drop off, dropout's keep probability 1."""

    cfg = rcnn_cars_config().model
    return r(
        cfg,
        image=r(cfg.image, height=64, width=192),
        sparse_pool=r(cfg.sparse_pool, max_points=1024, pool_channels=4),
        backbone=r(cfg.backbone, channels=(4, 8, 8, 8), blocks=(1, 1, 1, 1),
                   out_channels=8, compute_dtype="float32"),
        rpn=r(cfg.rpn, fusion_channels=16, pre_nms_top_k=640, eval_nms_size=32, train_nms_size=640),
        avod=r(cfg.avod, fc_layers=(32, 32, 32), nms_size=16, keep_dropout_prob=1.0, box_rep=box_rep),
        path_drop=r(cfg.path_drop, enabled=False),
    )


@pytest.mark.parametrize("full_width", [False, True])
def test_anchor_grid_matches_jax(full_width):
    cfg = rcnn_cars_config().model if full_width else rcnn_parity_config()
    ext = tcfg_mod.AreaExtents() if full_width else T_EXT
    jext = jcfg_mod.AreaExtents(**dataclasses.asdict(ext))
    want = j_fr.rcnn_anchor_grid(_jax_cfg(cfg), jext)
    got = t_pl.static_anchor_grid(cfg, ext, device="cpu").numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.shape == ((17600 if full_width else 640), 8)
    np.testing.assert_array_equal(got[0, [3, 5]], got[1, [5, 3]])  # rotations interleave per cell


# ---------------------------------------------------------------- the family

@pytest.fixture(scope="module", params=["offsets", "box_4c", "box_8c"])
def rcnn_run(request):
    """Serving and one training step of both packages on the same weights,
    frames and sampling noise."""

    cfg = rcnn_parity_config(request.param)
    frames = _frames(cfg, (2, 3))
    jax_run = _jax_run(cfg, frames, init_seed=0, loss_seed=11)
    port = _port_step(cfg, frames, jax_run["params"], jax_run["noise"])
    assert isinstance(port["model"], t_fr.FusionRcnn)
    return {"cfg": cfg, "jax": jax_run, "port": port}


_FLOAT_OUTPUTS = ("objectness", "rpn_offsets", "anchors", "proposals", "proposal_scores",
                  "cls_logits", "box_offsets", "orientation", "flip_logits")


@pytest.mark.parametrize("key", _FLOAT_OUTPUTS)
def test_forward_outputs_match_jax(rcnn_run, key):
    got, want = rcnn_run["port"]["out"][key], rcnn_run["jax"]["out"][key]
    _close(got.numpy(), want, key)
    if key == "box_offsets":
        assert got.shape[-1] == t_det.STAGE2_BOX_DIMS[rcnn_run["cfg"].avod.box_rep]


@pytest.mark.parametrize("key", ["anchor_valid", "proposal_valid"])
def test_forward_masks_match_jax(rcnn_run, key):
    got = rcnn_run["port"]["out"][key].numpy()
    np.testing.assert_array_equal(got, np.asarray(rcnn_run["jax"]["out"][key]))
    assert got.any() and (key == "proposal_valid" or got.all())


def test_detections_match_jax(rcnn_run):
    got, want = rcnn_run["port"]["det"], rcnn_run["jax"]["det"]
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].any()
    _close(got["scores"].numpy(), want["scores"], "scores")
    _close(got["boxes_3d"].numpy(), want["boxes_3d"], "boxes_3d")


_TERMS = ("total", "rpn_objectness", "rpn_regression", "cls", "reg", "orientation", "flip",
          "num_rpn_pos", "num_s2_pos")


@pytest.mark.parametrize("term", _TERMS)
def test_train_step_losses_match_jax(rcnn_run, term):
    got, want = rcnn_run["port"]["losses"][term].item(), float(rcnn_run["jax"]["losses"][term])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    if term in ("num_rpn_pos", "num_s2_pos", "rpn_regression", "reg"):
        assert got > 0  # both minibatches hold positives


def test_train_step_gradients_match_jax(rcnn_run):
    jg, tg = rcnn_run["jax"]["grads"], rcnn_run["port"]["grads"]
    assert set(jg) == set(tg)
    for name, want in jg.items():
        got = tg[name]
        assert got is not None and torch.isfinite(got).all(), name
        _close(got.numpy(), want.numpy(), name, floor=1e-8)
    for name in ("bev_extractor.encoder.conv1_1.weight", "img_fusion.mix1x1.weight",
                 "bev_fusion.pool_proj.weight", "rpn_head.offsets.weight", "stage2_head.box_reg.weight"):
        assert tg[name].abs().max() > 0, name


@pytest.mark.parametrize("flip_head", [True, False])
def test_decode_rcnn_detections_matches_jax(flip_head):
    """The offsets decode on fixed outputs: the angle vector's heading, its
    side from the flip head's logits where there is one; no ground plane."""

    cfg = r(rcnn_cars_config().model, avod=r(rcnn_cars_config().model.avod, explicit_flip_head=flip_head,
                                               nms_size=36))
    rng = np.random.RandomState(3 + int(flip_head))
    b, p = 2, 40
    proposals = np.concatenate([
        rng.uniform(-20, 20, (b, p, 1)), np.full((b, p, 1), 1.6), rng.uniform(5, 60, (b, p, 1)),
        np.array([3.9, 1.6, 1.5]) + rng.uniform(-0.3, 0.3, (b, p, 3)),
    ], -1).astype(np.float32)
    proposals[:, p // 2:] = proposals[:, :p // 2] + rng.normal(0, 0.3, (b, p // 2, 6))  # overlaps
    outputs = {
        "proposals": proposals,
        "box_offsets": rng.normal(0, 0.1, (b, p, 6)).astype(np.float32),
        "orientation": rng.normal(0, 1, (b, p, 2)).astype(np.float32),
        "cls_logits": rng.normal(0, 1, (b, p, 2)).astype(np.float32),
        "proposal_valid": rng.rand(b, p) < 0.8,
    }
    if flip_head:
        outputs["flip_logits"] = rng.normal(0, 1, (b, p, 2)).astype(np.float32)
    want = j_fr.decode_rcnn_detections({k: jnp.array(v) for k, v in outputs.items()}, _jax_cfg(cfg),
                                       jcfg_mod.AreaExtents())
    got = t_fr.decode_rcnn_detections({k: _t(v) for k, v in outputs.items()}, cfg, tcfg_mod.AreaExtents())
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].any() and not got["valid"].all()
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-6)
    np.testing.assert_allclose(got["boxes_3d"].numpy(), np.asarray(want["boxes_3d"]), atol=1e-4)


def test_corner_reps_need_the_ground_plane():
    cfg = rcnn_parity_config("box_8c")
    with pytest.raises(ValueError, match="ground_plane"):
        t_fr.decode_rcnn_detections({}, cfg, T_EXT)


def test_unported_options_still_raise():
    """What the JAX package rejects, the port rejects with the same type
    (remat and the dense grid run now: tests/test_torch_options_*.py)."""

    cfg = rcnn_parity_config()
    with pytest.raises(ValueError, match="architecture"):
        t_pl.make_model(r(cfg, architecture="mv3d"), T_EXT, device="cpu")
    avod = cars_pyramid_config().model
    with pytest.raises(ValueError, match="box_rep"):  # offsets are the rcnn family's, as in JAX
        t_pl.make_model(r(avod, avod=r(avod.avod, box_rep="offsets")), T_EXT, device="cpu")


# ---------------------------------------------------------------- box_8c

def test_box_8c_encoders_match_jax():
    rng = np.random.RandomState(5)
    b3 = _box3d(rng, 60)
    b3[:4, 6] = [-np.pi / 2, np.pi / 2, 0.0, np.pi]  # band edges
    gt = b3 + rng.normal(0, 0.2, b3.shape).astype(np.float32)
    pc, gc = (np.asarray(j_enc.box_3d_to_corners(x)) for x in (b3, gt))
    np.testing.assert_allclose(t_enc.box_3d_to_corners(_t(b3)).numpy(), pc, atol=1e-5)
    want_off = np.asarray(j_enc.box_8c_to_offsets(pc, gc))
    np.testing.assert_allclose(t_enc.box_8c_to_offsets(_t(pc), _t(gc)).numpy(), want_off, atol=1e-5)
    flat = want_off.reshape(-1, 24)
    for offsets in (flat, want_off):  # flat [.., 24] or [.., 8, 3]
        np.testing.assert_allclose(t_enc.offsets_to_box_8c(_t(pc), _t(offsets)).numpy(),
                                   np.asarray(j_enc.offsets_to_box_8c(pc, offsets)), atol=1e-5)
    noisy = gc + rng.normal(0, 0.05, gc.shape).astype(np.float32)  # not quite box-shaped
    np.testing.assert_allclose(t_enc.box_8c_to_box_3d(_t(noisy)).numpy(),
                               np.asarray(j_enc.box_8c_to_box_3d(noisy)), atol=1e-5)
    np.testing.assert_allclose(t_enc.offsets_to_box_8c(_t(pc), _t(want_off)).numpy(), gc, atol=1e-4)


@pytest.mark.parametrize("flip_head", [True, False])
def test_box_8c_decode_detections_matches_jax(flip_head):
    cfg = cars_pyramid_config().model
    cfg = r(cfg, avod=r(cfg.avod, box_rep="box_8c", explicit_flip_head=flip_head, nms_size=36))
    rng = np.random.RandomState(7 + int(flip_head))
    b, p = 2, 40
    proposals = np.concatenate([
        rng.uniform(-20, 20, (b, p, 1)), np.full((b, p, 1), 1.6), rng.uniform(5, 60, (b, p, 1)),
        np.array([3.9, 1.6, 1.5]) + rng.uniform(-0.3, 0.3, (b, p, 3)),
    ], -1).astype(np.float32)
    proposals[:, p // 2:] = proposals[:, :p // 2] + rng.normal(0, 0.3, (b, p // 2, 6))
    outputs = {
        "proposals": proposals,
        "box_offsets": rng.normal(0, 0.03, (b, p, 24)).astype(np.float32),
        "orientation": rng.normal(0, 1, (b, p, 2)).astype(np.float32),
        "cls_logits": rng.normal(0, 1, (b, p, 2)).astype(np.float32),
        "proposal_valid": rng.rand(b, p) < 0.8,
    }
    if flip_head:
        outputs["flip_logits"] = rng.normal(0, 1, (b, p, 2)).astype(np.float32)
    plane = np.array([[0.0, -1.0, 0.0, 1.65], [0.01, -1.0, 0.02, 1.6]], np.float32)
    want = j_det.decode_detections({k: jnp.array(v) for k, v in outputs.items()}, jnp.array(plane),
                                   _jax_cfg(cfg), jcfg_mod.AreaExtents())
    got = t_det.decode_detections({k: _t(v) for k, v in outputs.items()}, _t(plane), cfg, tcfg_mod.AreaExtents())
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].any() and not got["valid"].all()
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-6)
    np.testing.assert_allclose(got["boxes_3d"].numpy(), np.asarray(want["boxes_3d"]), atol=1e-4)


def avod_box_8c_config(stop_gradient_proposals=True):
    """``test_torch_train.parity_config`` with box_8c, every anchor through
    the RPN's NMS; with ``stop_gradient_proposals=False`` the proposals keep
    their gradient into stage 2 (the exact crops' box gradient)."""

    cfg = cars_pyramid_config().model
    return r(
        cfg,
        image=r(cfg.image, height=64, width=192),
        sparse_pool=r(cfg.sparse_pool, max_points=1024, pool_channels=4),
        anchors=r(cfg.anchors, max_anchors=512),
        backbone=r(cfg.backbone, channels=(4, 8, 8, 8), blocks=(1, 1, 1, 1),
                   out_channels=8, compute_dtype="float32"),
        rpn=r(cfg.rpn, roi_channels=4, fusion_channels=32, pre_nms_top_k=512, eval_nms_size=32,
              train_nms_size=512),
        avod=r(cfg.avod, fc_layers=(32, 32, 32), nms_size=16, keep_dropout_prob=1.0, box_rep="box_8c",
               stop_gradient_proposals=stop_gradient_proposals),
        path_drop=r(cfg.path_drop, enabled=False),
    )


@pytest.fixture(scope="module", params=[True, False], ids=["stop_gradient", "proposal_gradient"])
def avod_box_8c_step(request):
    cfg = avod_box_8c_config(request.param)
    frames = _frames(cfg, (2, 3))
    jax_run = _jax_run(cfg, frames, init_seed=0, loss_seed=13)
    port = _port_step(cfg, frames, jax_run["params"], jax_run["noise"])
    assert port["out"]["box_offsets"].shape[-1] == 24
    return jax_run, port


@pytest.mark.parametrize("term", _TERMS)
def test_box_8c_train_step_losses_match_jax(avod_box_8c_step, term):
    jax_run, port = avod_box_8c_step
    got = port["losses"][term].item()
    np.testing.assert_allclose(got, float(jax_run["losses"][term]), atol=TOL, rtol=TOL)
    if term in ("num_s2_pos", "reg"):
        assert got > 0


def test_box_8c_slice_detections_match_jax(avod_box_8c_step):
    jax_run, port = avod_box_8c_step
    _close(port["out"]["box_offsets"].numpy(), jax_run["out"]["box_offsets"], "box_offsets")
    np.testing.assert_array_equal(port["det"]["valid"].numpy(), np.asarray(jax_run["det"]["valid"]))
    assert port["det"]["valid"].any()
    _close(port["det"]["scores"].numpy(), jax_run["det"]["scores"], "scores")
    _close(port["det"]["boxes_3d"].numpy(), jax_run["det"]["boxes_3d"], "boxes_3d")


def test_box_8c_train_step_gradients_match_jax(avod_box_8c_step):
    jax_run, port = avod_box_8c_step
    jg, tg = jax_run["grads"], port["grads"]
    assert set(jg) == set(tg)
    for name, want in jg.items():
        assert tg[name] is not None, name
        _close(tg[name].numpy(), want.numpy(), name, floor=1e-8)
    assert tg["stage2_head.box_reg.weight"].abs().max() > 0


# ---------------------------------------------------------------- the exact crop's box gradient

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_crop_box_gradient_matches_jax(dtype):
    """Boxes inside, across and outside the map's edges; bf16 features
    (the box gradient still sums in f32)."""

    rng = np.random.RandomState(8)
    b, h, w, c, n = 2, 9, 13, 5, 11
    img = rng.randn(b, h, w, c).astype(np.float32)
    y1, x1 = rng.uniform(-2, h, (b, n)), rng.uniform(-2, w, (b, n))
    boxes = np.stack([y1, x1, y1 + rng.uniform(0.5, 5, (b, n)), x1 + rng.uniform(0.5, 6, (b, n))],
                     -1).astype(np.float32)
    g = rng.randn(b, n, 3, 4, c).astype(np.float32)
    jimg = jnp.array(img).astype(dtype)
    _, vjp = jax.vjp(lambda bx: j_crop.crop_and_resize_px_batch(jimg, bx, (3, 4)), jnp.array(boxes))
    (want,) = vjp(jnp.array(g).astype(dtype))
    tb = _t(boxes).requires_grad_(True)
    timg = _t(img).to(getattr(torch, dtype)).requires_grad_(True)
    t_crop.crop_and_resize_px_batch(timg, tb, (3, 4)).backward(_t(g).to(timg.dtype))
    _close(tb.grad.numpy(), np.asarray(want, np.float32), "box gradient", 1e-5 if dtype == "float32" else 2e-2,
           floor=1e-8)
    assert np.abs(tb.grad.numpy()).max() > 0 and timg.grad is not None


# ---------------------------------------------------------------- the people preset

def people_parity_config():
    """``people_pyramid_config()`` narrowed as ``test_torch_model.parity_config``
    narrows cars: the 0.3 m anchor stride over ``T_EXT`` is a 41x53 grid,
    which 4x4 blocks do not divide (it pads), 4 variants, 64 anchors a block."""

    cfg = people_pyramid_config().model
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


def people_frames(cfg, seeds):
    """Synthetic frames with ``gt_boxes_3d[0]`` a pedestrian (class 1) in the
    first and a cyclist (class 2) in the second, each 7 cm off an anchor of
    its class that the capped filter keeps (the cap of 8 blocks keeps the
    densest, near the sensor), so both minibatches hold positives. Off the
    anchor, no IoU sits on the positive band's edge of 1.0, where even the
    reference's jitted and eager IoUs differ by an ulp."""

    frames = [synthetic_frame(cfg, n_points=1024, seed=s, image="noise") for s in seeds]
    inputs = t_pl.build_model_inputs_batch(
        t_pl.stack_frames(frames, device="cpu"), t_pl.static_anchor_grid(cfg, T_EXT, device="cpu"),
        torch.ones(len(frames), 2), cfg, T_EXT)
    for i, frame in enumerate(frames):
        anchors, valid = inputs["anchors"][i], inputs["anchor_valid"][i]
        first = int(torch.nonzero(valid & (anchors[:, 7] == i) & (anchors[:, 6] == 0))[0])
        x, y, z = anchors[first, :3].tolist()
        frame["gt_boxes_3d"][0] = [x + 0.07, y, z + 0.07, *cfg.anchors.sizes[i], 0.0]
        frame["gt_classes"][0] = i + 1
    return frames


@pytest.fixture(scope="module")
def people_step():
    """One training step of the narrowed people preset (two classes, every
    anchor through the RPN's NMS), both packages, the same noise."""

    cfg = people_parity_config()
    cfg = r(cfg, rpn=r(cfg.rpn, pre_nms_top_k=512, train_nms_size=512),
            avod=r(cfg.avod, keep_dropout_prob=1.0), path_drop=r(cfg.path_drop, enabled=False))
    frames = people_frames(cfg, (4, 5))
    jax_run = _jax_run(cfg, frames, init_seed=1, loss_seed=17)
    return jax_run, _port_step(cfg, frames, jax_run["params"], jax_run["noise"])


@pytest.mark.parametrize("term", _TERMS)
def test_people_train_step_losses_match_jax(people_step, term):
    jax_run, port = people_step
    got = port["losses"][term].item()
    np.testing.assert_allclose(got, float(jax_run["losses"][term]), atol=TOL, rtol=TOL)
    if term in ("num_rpn_pos", "num_s2_pos", "rpn_regression", "reg"):
        assert got > 0


def test_people_train_step_gradients_match_jax(people_step):
    jax_run, port = people_step
    jg, tg = jax_run["grads"], port["grads"]
    assert set(jg) == set(tg)
    for name, want in jg.items():
        assert tg[name] is not None, name
        _close(tg[name].numpy(), want.numpy(), name, floor=1e-8)
    assert tg["stage2_head.cls.weight"].abs().max() > 0 and tg["bev_roi_proj.weight"].abs().max() > 0


@pytest.fixture(scope="module")
def people_run():
    from sparse_pooling_tpu_torch.ops import anchors as t_anchors

    cfg = people_parity_config()
    assert cfg.num_classes == 2 and cfg.rpn.roi_quad == 4 and cfg.anchors.stride == 0.3
    nz, nx = t_anchors.grid_shape(cfg.anchors, T_EXT)
    assert (nz, nx) == (41, 53) and nz % 4 and nx % 4
    assert t_anchors.quad_supported(cfg.anchors, cfg.bev, T_EXT, cfg.anchors.max_anchors, 4)
    frames = [synthetic_frame(cfg, n_points=1024, seed=s, image="noise") for s in (4, 5)]
    jax_run = _jax_run(cfg, frames, init_seed=1)
    port = _port_step(cfg, frames, jax_run["params"], None)
    return jax_run["out"], jax_run["det"], port["out"], port["det"]


@pytest.mark.parametrize("key", _FLOAT_OUTPUTS)
def test_people_outputs_match_jax(people_run, key):
    jout, _, tout, _ = people_run
    _close(tout[key].numpy(), jout[key], key)


def test_people_detections_match_jax(people_run):
    jout, jdet, tout, tdet = people_run
    for key in ("anchor_valid", "proposal_valid"):
        np.testing.assert_array_equal(tout[key].numpy(), np.asarray(jout[key]), err_msg=key)
    assert tout["anchor_valid"].any() and not tout["anchor_valid"].all()
    assert set(np.unique(tout["anchors"][..., 7].numpy())) == {0.0, 1.0}  # both classes' anchors
    assert tdet["boxes_3d"].shape == (2, 2, 16, 7) and tout["cls_logits"].shape[-1] == 3
    np.testing.assert_array_equal(tdet["valid"].numpy(), np.asarray(jdet["valid"]))
    assert tdet["valid"][:, 0].any() and tdet["valid"][:, 1].any()
    _close(tdet["scores"].numpy(), jdet["scores"], "scores")
    _close(tdet["boxes_3d"].numpy(), jdet["boxes_3d"], "boxes_3d")


def test_people_kitti_dataset_matches_jax(tmp_path):
    """The people preset's class map over a tree of the JAX writer's people
    scenes: every sample (labels of both classes, class ids 1 and 2, boxes,
    points, image) equals the JAX ``KittiDataset``'s, augmented or not."""

    from sparse_pooling_tpu.data import dataset as j_dataset
    from sparse_pooling_tpu_torch.data import dataset as t_dataset

    root = str(tmp_path)
    j_syn.write_kitti_tree(root, num_frames=3, n_ground=3000, n_obj=200, val_frames=(2,), scene="people")
    cfg = people_pyramid_config()
    cfg = r(cfg, dataset=r(cfg.dataset, root=root, split="trainval"))
    jcfg = jcfg_mod.pipeline_config_from_dict(dataclasses.asdict(cfg))
    ext = tcfg_mod.AreaExtents()
    tds = t_dataset.KittiDataset(cfg.dataset, cfg.model, ext)
    jds = j_dataset.KittiDataset(jcfg.dataset, jcfg.model, jcfg_mod.AreaExtents(**dataclasses.asdict(ext)))
    assert tds.sample_ids == jds.sample_ids and len(tds) == 3
    classes = set()
    for sid in tds.sample_ids:
        for seed in (None, 3):
            got, want = tds.load_sample(sid, augment_seed=seed), jds.load_sample(sid, augment_seed=seed)
            for a, b in zip(got.as_arrays(), want.as_arrays()):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            classes |= set(got.gt_classes[got.gt_valid].tolist())
    assert classes == {1, 2}  # Pedestrian and Cyclist


# ---------------------------------------------------------------- Trainer, then Evaluator

E2E_EXT = tcfg_mod.AreaExtents(x_min=-20.0, x_max=20.0, z_min=0.0, z_max=39.6)  # a 400x400 lattice
E2E_STEP = 2
TOL_2D, TOL_3D = 1e-3, 1e-4  # px; m, rad and score (tests/test_torch_eval.py)


def rcnn_pipeline_config(root, workdir):
    """``rcnn_cars_config()`` over a 5-frame tree, narrowed as
    tests/test_torch_eval.py narrows cars (thin layers, 1024 points), batch 2,
    every detection written."""

    cfg = rcnn_cars_config()
    m = cfg.model
    model = r(
        m,
        sparse_pool=r(m.sparse_pool, max_points=1024, point_buckets=(512,), pool_channels=4),
        backbone=r(m.backbone, channels=(4, 4, 4, 4), blocks=(1, 1, 1, 1), out_channels=4,
                   compute_dtype="float32"),
        rpn=r(m.rpn, fusion_channels=8, pre_nms_top_k=128, eval_nms_size=16, train_nms_size=16),
        avod=r(m.avod, fc_layers=(16,), nms_size=8, keep_dropout_prob=1.0),
    )
    return r(cfg, model=model, experiments_dir=workdir, checkpoint_name="rcnn",
             dataset=r(cfg.dataset, root=root),
             train=r(cfg.train, batch_size=2, checkpoint_interval=1, summary_interval=1),
             eval=r(cfg.eval, batch_size=2, kitti_score_threshold=0.0, score_threshold=0.0,
                    save_rpn_proposals=True, num_workers=2))


def _to_flax(sd, template, cfg):
    """The port's state dict as the flax tree ``template`` lays it out (the
    inverse of ``weights.from_flax``)."""

    upconvs = weights._transposed_conv_names(cfg)

    def walk(node, path):
        if "kernel" in node:
            name = ".".join(path)
            w = sd[f"{name}.weight"].detach().float().numpy()
            if w.ndim == 4 and path[-1] in upconvs:
                k = w.transpose(2, 3, 0, 1)[::-1, ::-1]
            elif w.ndim == 4:
                k = w.transpose(2, 3, 1, 0)
            else:
                k = w.T
            assert k.shape == node["kernel"].shape, name
            out = {"kernel": jnp.array(np.ascontiguousarray(k))}
            if "bias" in node:
                out["bias"] = jnp.array(sd[f"{name}.bias"].detach().float().numpy())
            return out
        return {key: walk(child, path + (key,)) for key, child in node.items()}

    return {"params": walk(template["params"], ())}


def _pred_rows(workdir, step):
    return _rows_in(os.path.join(workdir, "predictions", "kitti_native_eval", "0", str(step), "data"))


def _rows_in(directory):
    out = {}
    for path in sorted(glob.glob(os.path.join(directory, "*.txt"))):
        with open(path) as f:
            rows = [line.split() for line in f if line.strip()]
        out[os.path.basename(path)] = ([row[0] for row in rows],
                                       np.array([[float(v) for v in row[3:]] for row in rows]).reshape(-1, 13))
    return out


@pytest.fixture(scope="module")
def rcnn_e2e(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rcnn_tree"))
    j_syn.write_kitti_tree(root, num_frames=5, n_ground=6000, n_obj=300, val_frames=(2, 3, 4))
    twork = str(tmp_path_factory.mktemp("rcnn_port"))
    cfg = rcnn_pipeline_config(root, twork)
    state = Trainer(cfg, extents=E2E_EXT, device="cpu").train(max_steps=E2E_STEP)
    workdir = os.path.join(twork, "rcnn")
    ecfg = r(cfg, dataset=r(cfg.dataset, split="val"))
    tres = Evaluator(ecfg, extents=E2E_EXT, workdir=workdir, device="cpu").run_checkpoint_once(E2E_STEP)

    jwork = str(tmp_path_factory.mktemp("rcnn_jax"))
    jcfg = jcfg_mod.pipeline_config_from_dict(dataclasses.asdict(ecfg))
    jev = j_evaluator.Evaluator(jcfg, extents=jcfg_mod.AreaExtents(**dataclasses.asdict(E2E_EXT)), workdir=jwork)
    sd = ckpt_mod.restore(os.path.join(workdir, "checkpoints"), E2E_STEP)["model"]
    jres = jev.run_checkpoint_once(E2E_STEP, params=_to_flax(sd, jev._params_template(), cfg.model))
    return dict(state=state, tres=tres, jres=jres, twork=workdir, jwork=jwork, root=root)


def test_rcnn_trainer_then_evaluator_write_the_jax_rows(rcnn_e2e):
    assert rcnn_e2e["state"].step == E2E_STEP
    assert isinstance(rcnn_e2e["state"].model, t_fr.FusionRcnn)
    got, want = _pred_rows(rcnn_e2e["twork"], E2E_STEP), _pred_rows(rcnn_e2e["jwork"], E2E_STEP)
    assert sorted(got) == sorted(want) == [f"{i:06d}.txt" for i in (2, 3, 4)]
    n = 0
    for name in want:
        (gc, gv), (wc, wv) = got[name], want[name]
        assert gc == wc, name
        np.testing.assert_allclose(gv[:, 1:5], wv[:, 1:5], atol=TOL_2D, rtol=0)
        np.testing.assert_allclose(gv[:, [0, *range(5, 13)]], wv[:, [0, *range(5, 13)]], atol=TOL_3D, rtol=0)
        n += len(gc)
    assert n > 0, "no rows written"


def test_rcnn_trainer_then_evaluator_ap_matches_jax(rcnn_e2e):
    tres, jres = rcnn_e2e["tres"], rcnn_e2e["jres"]
    assert tres["num_frames"] == jres["num_frames"] == 3
    assert tres["ap"].keys() == jres["ap"].keys() == {"Car"}
    for metric, by_diff in jres["ap"]["Car"].items():
        for diff, want in by_diff.items():
            assert abs(tres["ap"]["Car"][metric][diff] - want) <= 1e-6, (metric, diff)


def test_rcnn_clis_train_evaluate_and_infer(rcnn_e2e, tmp_path):
    """The three CLIs on the CPU with the narrowed rcnn config (at the
    default extents): ``run_training`` takes a step into a ``FusionRcnn``
    checkpoint, ``run_evaluation --ckpt_step 1`` scores it, ``run_inference``
    at batch 1 writes the rows the evaluation wrote at batch 2."""

    from sparse_pooling_tpu_torch.experiments import run_evaluation, run_inference, run_training

    assert run_training.load_config(run_training.parse_args(["--preset", "rcnn_cars"])).model.architecture == "rcnn"
    root = rcnn_e2e["root"]
    exp = tmp_path / "exp"
    cfg = rcnn_pipeline_config(root, str(exp))
    path = tmp_path / "pipeline.json"
    path.write_text(cfg.to_json())
    common = ["--pipeline_config", str(path), "--dataset_root", root, "--experiments_dir", str(exp),
              "--device", "cpu"]
    state = run_training.main(common + ["--data_split", "train", "--max_steps", "1"])
    assert state.step == 1 and isinstance(state.model, t_fr.FusionRcnn)
    workdir = exp / cfg.checkpoint_name
    (res,) = run_evaluation.main(common + ["--ckpt_step", "1"])
    assert res["num_frames"] == 3 and res["ap_backend"] == "native_cpp"
    out_dir = run_inference.main(common)
    assert out_dir == str(workdir / "inference" / "1")
    got, want = _rows_in(out_dir), _pred_rows(str(workdir), 1)
    assert sorted(got) == sorted(want) and sum(len(c) for c, _ in want.values()) > 0
    for name, (wc, wv) in want.items():
        gc, gv = got[name]
        assert gc == wc, name
        np.testing.assert_allclose(gv[:, 1:5], wv[:, 1:5], atol=TOL_2D, rtol=0)
        np.testing.assert_allclose(gv[:, [0, *range(5, 13)]], wv[:, [0, *range(5, 13)]], atol=TOL_3D, rtol=0)
