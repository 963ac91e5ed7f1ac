"""Training parity of the PyTorch port with the JAX package on the CPU.

Seeded numpy inputs go through both packages; the port runs with
``device="cpu"`` (the kernels' plain twins). Where JAX draws random numbers
(the minibatch priorities), the test derives the same draws from JAX's keys
and hands them to the port.

* ``ops/iou.py``, ``ops/losses.py`` and the new encoders: 1e-6;
* ``sample_minibatch`` with JAX's own noise: every output equal, also for a
  frame with no valid GT;
* ``detector_loss_batch`` on fixed outputs: 1e-5;
* ``sample_path_keep``: its frequencies, and never both branches dropped;
* ``build_optimizer``: two steps of Adam, SGD and RMSprop with staircase
  decay and the global-norm clip against optax, 1e-6 (one leaf's gradients
  are ~1e-7, where eps inside or outside the root would differ by 1e3x);
* the whole training step on the narrow parity config of
  ``test_torch_model.py`` (f32, ``train_nms_size`` 32, path drop off, keep
  probability 1): loss terms to 1e-4, and every parameter's gradient to
  1e-4 of that parameter's largest gradient (6e-6 measured: f32 sums of a
  few thousand products in other orders, through convs, the pools, the
  crops and the FC heads);
* ``Trainer`` on the CPU: 2 steps, checkpoints, a resume to step 3.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")
pytest.importorskip("flax")  # the JAX package imports flax

from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.models import loss as j_loss  # noqa: E402
from sparse_pooling_tpu.models import pipeline as j_pl  # noqa: E402
from sparse_pooling_tpu.ops import encoders as j_enc  # noqa: E402
from sparse_pooling_tpu.ops import iou as j_iou  # noqa: E402
from sparse_pooling_tpu.ops import losses as j_losses  # noqa: E402
from sparse_pooling_tpu.ops import target_assign as j_ta  # noqa: E402
from sparse_pooling_tpu.runtime import trainer as j_trainer  # noqa: E402
from sparse_pooling_tpu_torch import weights  # noqa: E402
from sparse_pooling_tpu_torch.configs import cars_pyramid_config  # noqa: E402
from sparse_pooling_tpu_torch.configs import config as tcfg_mod  # noqa: E402
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame  # noqa: E402
from sparse_pooling_tpu_torch.models import loss as t_loss  # noqa: E402
from sparse_pooling_tpu_torch.models import pipeline as t_pl  # noqa: E402
from sparse_pooling_tpu_torch.ops import encoders as t_enc  # noqa: E402
from sparse_pooling_tpu_torch.ops import iou as t_iou  # noqa: E402
from sparse_pooling_tpu_torch.ops import losses as t_losses  # noqa: E402
from sparse_pooling_tpu_torch.ops import target_assign as t_ta  # noqa: E402
from sparse_pooling_tpu_torch.runtime import checkpoint as t_ckpt  # noqa: E402
from sparse_pooling_tpu_torch.runtime import trainer as t_trainer  # noqa: E402
from sparse_pooling_tpu_torch.runtime.summary import read_scalars  # noqa: E402

T_EXT = tcfg_mod.AreaExtents(x_min=-8.0, x_max=8.0, z_min=0.0, z_max=12.4)
J_EXT = jcfg_mod.AreaExtents(**dataclasses.asdict(T_EXT))


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng, n, lo=0.0, hi=10.0):
    y1, x1 = rng.uniform(lo, hi, n), rng.uniform(lo, hi, n)
    return np.stack([y1, x1, y1 + rng.uniform(0, 3, n), x1 + rng.uniform(0, 3, n)], -1).astype(np.float32)


def _box3d(rng, n):
    return np.stack([
        rng.uniform(-6, 6, n), rng.uniform(1.4, 1.9, n), rng.uniform(2, 11, n),
        rng.uniform(3.2, 4.6, n), rng.uniform(1.4, 1.9, n), rng.uniform(1.3, 1.7, n),
        rng.uniform(-np.pi, np.pi, n),
    ], -1).astype(np.float32)


# ---------------------------------------------------------------- small ops

def test_pairwise_iou_matches_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 40), _boxes(rng, 7)
    a[3] = a[4]  # a duplicate, and an empty box
    a[5, 2:] = a[5, :2]
    np.testing.assert_allclose(t_iou.pairwise_iou(_t(a), _t(b)).numpy(),
                               np.asarray(j_iou.pairwise_iou(a, b)), atol=1e-6)
    np.testing.assert_allclose(t_iou.pairwise_intersection(_t(a), _t(b)).numpy(),
                               np.asarray(j_iou.pairwise_intersection(a, b)), atol=1e-6)
    # leading batch dims: each frame as the one-frame function
    batched = t_iou.pairwise_iou(_t(np.stack([a, a[::-1]])), _t(np.stack([b, b])))
    np.testing.assert_allclose(batched[1].numpy(), np.asarray(j_iou.pairwise_iou(a[::-1], b)), atol=1e-6)


@pytest.mark.parametrize("empty", [False, True])
def test_losses_match_jax(empty):
    rng = np.random.RandomState(1)
    pred, tgt = rng.randn(30, 6).astype(np.float32) * 2, rng.randn(30, 6).astype(np.float32)
    logits = rng.randn(30, 3).astype(np.float32) * 3
    onehot = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 30)]
    w = (rng.rand(30) < 0.5).astype(np.float32) * (0.0 if empty else 1.0)
    np.testing.assert_allclose(t_losses.smooth_l1(_t(pred), _t(tgt)).numpy(),
                               np.asarray(j_losses.smooth_l1(pred, tgt)), atol=1e-6)
    got = t_losses.weighted_smooth_l1(_t(pred), _t(tgt), _t(w)).item()
    np.testing.assert_allclose(got, float(j_losses.weighted_smooth_l1(pred, tgt, w)), atol=1e-6)
    got = t_losses.weighted_softmax_ce(_t(logits), _t(onehot), _t(w)).item()
    np.testing.assert_allclose(got, float(j_losses.weighted_softmax_ce(logits, onehot, w)), atol=1e-6)
    if empty:
        assert got == 0.0  # the guarded normalizer


def test_new_encoders_match_jax():
    rng = np.random.RandomState(2)
    b3 = _box3d(rng, 50)
    b3[:6, 6] = [-np.pi / 2, np.pi / 2, np.pi, -np.pi, 0.0, 3 * np.pi / 2]  # band edges
    anchors = np.asarray(j_enc.box_3d_to_anchor(b3))
    gt = anchors + rng.uniform(-0.3, 0.3, anchors.shape).astype(np.float32)
    np.testing.assert_allclose(t_enc.anchor_to_offset(_t(anchors), _t(gt)).numpy(),
                               np.asarray(j_enc.anchor_to_offset(anchors, gt)), atol=1e-6)
    np.testing.assert_allclose(t_enc.angle_to_vector(_t(b3[:, 6])).numpy(),
                               np.asarray(j_enc.angle_to_vector(b3[:, 6])), atol=1e-6)
    np.testing.assert_array_equal(t_enc.heading_flip_bit(_t(b3[:, 6])).numpy(),
                                  np.asarray(j_enc.heading_flip_bit(b3[:, 6])))
    plane = np.array([0.01, -1.0, 0.02, 1.65], np.float32)
    c4a = np.asarray(j_enc.box_3d_to_box_4c(b3, plane))
    c4b = np.asarray(j_enc.box_3d_to_box_4c(b3[::-1].copy(), plane))
    np.testing.assert_allclose(t_enc.box_4c_to_offsets(_t(c4a), _t(c4b)).numpy(),
                               np.asarray(j_enc.box_4c_to_offsets(c4a, c4b)), atol=1e-6)


# ---------------------------------------------------------------- sampling

def _jax_noise(key, a):
    return np.asarray(jax.random.uniform(key, (a,)))


@pytest.mark.parametrize("with_gt", [True, False])
def test_sample_minibatch_matches_jax(with_gt):
    """Two frames through the port at once, each against JAX with its key;
    the second has no valid GT (no positives, background everywhere)."""

    rng = np.random.RandomState(3)
    a, g, k = 600, 5, 64
    gt = _boxes(rng, g, 0, 8)
    near = np.repeat(gt, 40, 0) + rng.uniform(-0.4, 0.4, (40 * g, 4)).astype(np.float32)
    anchors = np.concatenate([near, _boxes(rng, a - 40 * g, -2, 12)])
    valid = rng.rand(a) < 0.9
    gt_valid = np.array([True, True, False, True, True]) if with_gt else np.zeros(g, bool)
    cls = np.array([1, 2, 1, 2, 1], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    frames = [(anchors, valid, gt, gt_valid), (anchors[::-1].copy(), valid, gt, np.zeros(g, bool))]
    want = [j_ta.sample_minibatch(jnp.array(an), jnp.array(v), jnp.array(gb), jnp.array(gv),
                                  jnp.array(cls), key, k) for (an, v, gb, gv), key in zip(frames, keys)]
    stack = lambda i: _t(np.stack([f[i] for f in frames]))  # noqa: E731
    got = t_ta.sample_minibatch(stack(0), stack(1), stack(2), stack(3), _t(np.stack([cls, cls])),
                                _t(np.stack([_jax_noise(key, a) for key in keys])), k)
    for f, w in enumerate(want):
        for name in ("indices", "weights", "is_pos", "cls_target", "gt_idx", "max_iou"):
            np.testing.assert_array_equal(getattr(got, name)[f].numpy(), np.asarray(getattr(w, name)),
                                          err_msg=f"frame {f} {name}")
    assert not got.is_pos[1].any() and (got.cls_target[1] == 0).all()
    if with_gt:
        assert got.is_pos[0].sum() > 5


def test_sample_minibatch_ties_go_to_the_lower_index():
    """Equal priorities keep array order, as lax.top_k (a stable sort)."""

    anchors = torch.tensor([[[0.0, 0.0, 1.0, 1.0]] * 6])
    noise = torch.tensor([[0.5, 0.25, 0.5, 0.25, 0.5, 0.25]])
    gt = torch.tensor([[[5.0, 5.0, 6.0, 6.0]]])
    mb = t_ta.sample_minibatch(anchors, torch.ones(1, 6, dtype=torch.bool), gt,
                               torch.ones(1, 1, dtype=torch.bool), torch.ones(1, 1, dtype=torch.int32),
                               noise, 4)
    assert mb.indices[0].tolist() == [0, 2, 4, 1]


def _loss_noise(rng_key, b, a, p):
    """The RPN and stage-2 priorities the JAX loss draws from ``rng_key``
    (``detector_loss_batch``: one key per frame, split into RPN and stage 2)."""

    rpn, s2 = [], []
    for key in jax.random.split(rng_key, b):
        k_rpn, k_s2 = jax.random.split(key)
        rpn.append(_jax_noise(k_rpn, a))
        s2.append(_jax_noise(k_s2, p))
    return _t(np.stack(rpn)), _t(np.stack(s2))


def _cfg_pair(model_cfg):
    jcfg = jcfg_mod.pipeline_config_from_dict({"model": dataclasses.asdict(model_cfg)}).model
    return model_cfg, jcfg


def test_detector_loss_batch_matches_jax():
    """Fixed outputs of two frames (the second without valid GT), anchors and
    proposals scattered around the GT so both minibatches hold positives."""

    tcfg, jcfg = _cfg_pair(cars_pyramid_config().model)
    rng = np.random.RandomState(4)
    b, a, p, g = 2, 600, 64, 4
    gt = np.stack([_box3d(rng, g) for _ in range(b)])
    gt_valid = np.array([[True, True, False, True], [False] * g])
    gt_cls = np.ones((b, g), np.int32)
    plane = np.array([[0.0, -1.0, 0.0, 1.65], [0.01, -1.0, 0.02, 1.6]], np.float32)

    def around(n):
        base = np.asarray(j_enc.box_3d_to_anchor(gt[:, rng.randint(0, g, n)]))
        return (base + rng.normal(0, 0.15, base.shape)).astype(np.float32)

    anchors = np.concatenate([around(a), rng.uniform(0, 1, (b, a, 2)).astype(np.float32)], -1)
    outputs = {
        "anchors": anchors, "anchor_valid": rng.rand(b, a) < 0.95,
        "objectness": rng.randn(b, a, 2).astype(np.float32),
        "rpn_offsets": rng.randn(b, a, 6).astype(np.float32) * 0.3,
        "proposals": around(p), "proposal_valid": rng.rand(b, p) < 0.9,
        "cls_logits": rng.randn(b, p, 2).astype(np.float32),
        "box_offsets": rng.randn(b, p, 10).astype(np.float32) * 0.2,
        "orientation": rng.randn(b, p, 2).astype(np.float32),
        "flip_logits": rng.randn(b, p, 2).astype(np.float32),
    }
    key = jax.random.PRNGKey(9)
    want = j_loss.detector_loss_batch({k: jnp.array(v) for k, v in outputs.items()}, jnp.array(gt),
                                      jnp.array(gt_valid), jnp.array(gt_cls), jnp.array(plane), key,
                                      jcfg, J_EXT)
    got = t_loss.detector_loss_batch({k: _t(v) for k, v in outputs.items()}, _t(gt), _t(gt_valid),
                                     _t(gt_cls), _t(plane), tcfg, T_EXT, noise=_loss_noise(key, b, a, p))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].item(), float(want[name]), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    assert got["num_rpn_pos"] > 0 and got["num_s2_pos"] > 0 and got["reg"] > 0


def test_sample_path_keep_statistics():
    """Each branch kept with its probability, revived half the time when both
    drop: P(bev) = P(img) = 0.9 + 0.01 / 2, P(both) = 0.81; never neither."""

    cfg = cars_pyramid_config().model
    keep = t_pl.sample_path_keep(torch.Generator().manual_seed(0), cfg, batch_size=40000)
    assert keep.shape == (40000, 2) and keep.dtype == torch.float32
    assert bool((keep.sum(-1) >= 1).all())
    np.testing.assert_allclose(keep.mean(0).numpy(), [0.905, 0.905], atol=0.006)
    np.testing.assert_allclose((keep.sum(-1) == 2).float().mean().item(), 0.81, atol=0.008)
    one = t_pl.sample_path_keep(torch.Generator().manual_seed(1), cfg)
    assert one.shape == (2,)
    off = dataclasses.replace(cfg, path_drop=dataclasses.replace(cfg.path_drop, enabled=False))
    assert bool((t_pl.sample_path_keep(None, off, batch_size=5) == 1).all())
    jkeep = np.stack([np.asarray(j_pl.sample_path_keep(k, _cfg_pair(cfg)[1]))
                      for k in jax.random.split(jax.random.PRNGKey(0), 4000)])
    np.testing.assert_allclose(jkeep.mean(0), keep.mean(0).numpy(), atol=0.02)


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop"])
def test_build_optimizer_matches_optax(name):
    """Two updates with the rate halved after the first (staircase, 1 step a
    stage) and the global-norm clip active on the first."""

    oc = tcfg_mod.OptimizerConfig(name=name, initial_lr=1e-2, decay_steps=1, decay_rate=0.5,
                                  staircase=True, grad_clip_norm=1.0)
    cfg = tcfg_mod.PipelineConfig(train=tcfg_mod.TrainConfig(optimizer=oc))
    jcfg = jcfg_mod.pipeline_config_from_dict({"train": dataclasses.asdict(cfg.train)})
    rng = np.random.RandomState(6)
    params = {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    grads = [{"w": rng.randn(5, 3).astype(np.float32) * 3, "b": rng.randn(3).astype(np.float32) * 1e-7},
             {"w": rng.randn(5, 3).astype(np.float32) * 0.1, "b": rng.randn(3).astype(np.float32) * 1e-7}]
    tx = j_trainer.build_optimizer(jcfg)
    jp = {k: jnp.array(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v.copy())) for k, v in params.items()}
    opt, sched = t_trainer.build_optimizer(list(tp.values()), cfg)
    for g in grads:
        upd, state = tx.update({k: jnp.array(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = _t(g[k].copy())
        norm = t_trainer.global_norm([p.grad for p in tp.values()])
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        t_trainer.clip_by_global_norm([p.grad for p in tp.values()], oc.grad_clip_norm, norm)
        opt.step()
        sched.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6, err_msg=k)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.25)


# ---------------------------------------------------------------- the whole step

def parity_config():
    """``test_torch_model.parity_config`` in training: ``train_nms_size`` 32,
    path drop off, dropout's keep probability 1."""

    cfg = cars_pyramid_config().model
    r = dataclasses.replace
    return r(
        cfg,
        image=r(cfg.image, height=64, width=192),
        sparse_pool=r(cfg.sparse_pool, max_points=1024, pool_channels=4),
        anchors=r(cfg.anchors, max_anchors=512),
        backbone=r(cfg.backbone, channels=(4, 8, 8, 8), blocks=(1, 1, 1, 1),
                   out_channels=8, compute_dtype="float32"),
        rpn=r(cfg.rpn, roi_channels=4, fusion_channels=32, pre_nms_top_k=256, eval_nms_size=32,
              train_nms_size=32),
        avod=r(cfg.avod, fc_layers=(32, 32, 32), nms_size=16, keep_dropout_prob=1.0),
        path_drop=r(cfg.path_drop, enabled=False),
    )


def gt_on_cluster(frame, ext):
    """Move ``gt_boxes_3d[0]`` onto the synthetic frame's densest car-like
    cluster inside ``ext`` (above the ground, off the lateral walls), so the
    minibatches hold positives."""

    pts = frame["points"][frame["points_mask"]]
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    ok = (y < 1.5) & (np.abs(x) < 0.45 * z + 2) & (x > ext.x_min + 2) & (x < ext.x_max - 2) \
        & (z > ext.z_min + 1) & (z < ext.z_max - 2)
    cx, cz = x[ok], z[ok]
    near = (np.abs(cx[:, None] - cx[None]) < 2.0) & (np.abs(cz[:, None] - cz[None]) < 1.0)
    members = near[np.argmax(near.sum(1))]
    assert members.sum() >= 8, "no point cluster inside the extents"
    frame["gt_boxes_3d"][0] = [cx[members].mean(), 1.65, cz[members].min() + 0.8, 3.9, 1.6, 1.5, 0.0]
    return frame


def _frames(cfg, seeds, n_points=1024):
    return [gt_on_cluster(synthetic_frame(cfg, n_points=n_points, seed=s, image="noise"), T_EXT)
            for s in seeds]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def step_run():
    """One training step of both packages on the same weights, frames and
    sampling noise: JAX's loss terms and gradients, the port's."""

    cfg = parity_config()
    _, jcfg = _cfg_pair(cfg)
    frames = _frames(cfg, (2, 3))
    jmodel = j_pl.make_model(jcfg, J_EXT)
    janchors = jnp.array(j_pl.static_anchor_grid(jcfg, J_EXT))
    jbatch = j_pl.RawSample(**{k: jnp.array(np.stack([f[k] for f in frames])) for k in j_pl.RawSample._fields})

    def init(key, batch):
        raw0 = jax.tree.map(lambda x: x[0], batch)
        inputs = j_pl.build_model_inputs(raw0, janchors, jnp.ones((2,), jnp.float32), jcfg, J_EXT)
        return jmodel.init({"params": key, "dropout": key}, inputs, train=False)

    def loss_fn(params, batch, key):  # the reference train step's loss_fn
        r_fwd, r_loss = jax.random.split(key)
        out = j_pl.forward_batch_fn(jmodel, params, batch, janchors, jcfg, J_EXT, True, r_fwd)
        losses = j_pl.loss_batch(out, batch, r_loss, jcfg, J_EXT)
        return losses["total"], (losses, out["anchors"].shape[1], out["proposals"].shape[1])

    params = jax.jit(init)(jax.random.PRNGKey(0), jbatch)
    key = jax.random.PRNGKey(11)
    (_, (jlosses, a, p)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, jbatch, key)

    model = t_pl.make_model(cfg, T_EXT, device="cpu")
    model.load_state_dict(weights.from_flax(_np_tree(params), cfg), strict=True)
    batch = t_pl.stack_frames(frames, device="cpu")
    out = t_pl.forward_batch_fn(model, batch, t_pl.static_anchor_grid(cfg, T_EXT, device="cpu"), cfg,
                                T_EXT, train=True)
    noise = _loss_noise(jax.random.split(key)[1], len(frames), a, p)
    losses = t_pl.loss_batch(out, batch, cfg, T_EXT, noise=noise)
    losses["total"].backward()
    tgrads = {n: prm.grad for n, prm in model.named_parameters()}
    return jlosses, losses, weights.from_flax(_np_tree(jgrads), cfg), tgrads


_TERMS = ("total", "rpn_objectness", "rpn_regression", "cls", "reg", "orientation", "flip",
          "num_rpn_pos", "num_s2_pos")


@pytest.mark.parametrize("term", _TERMS)
def test_train_step_losses_match_jax(step_run, term):
    jl, tl, _, _ = step_run
    np.testing.assert_allclose(tl[term].item(), float(jl[term]), atol=1e-4, rtol=1e-4)
    if term in ("num_rpn_pos", "num_s2_pos", "rpn_regression", "reg"):
        assert tl[term].item() > 0  # the minibatches hold positives


def test_train_step_gradients_match_jax(step_run):
    _, _, jg, tg = step_run
    assert set(jg) == set(tg)
    for name, want in jg.items():
        got = tg[name]
        assert got is not None and torch.isfinite(got).all(), name
        scale = max(want.abs().max().item(), 1e-8)
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * scale, f"{name}: max abs err {err:.3e} > 1e-4 * {scale:.3e}"
    # every part of the model learns: the backbones (through A and C), heads
    for name in ("bev_extractor.encoder.conv1_1.weight", "img_fusion.mix1x1.weight",
                 "bev_roi_proj.weight", "rpn_head.fc1.weight", "stage2_head.fc1.weight"):
        assert tg[name].abs().max() > 0, name


# ---------------------------------------------------------------- the trainer

def test_trainer_two_steps_checkpoint_and_resume(tmp_path):
    """Mirror of tests/test_runtime.py::test_trainer_two_steps_and_resume."""

    cfg = tcfg_mod.PipelineConfig(
        model=parity_config(),
        train=tcfg_mod.TrainConfig(batch_size=2, checkpoint_interval=1, summary_interval=1),
    )
    ds = t_trainer.FrameDataset(_frames(cfg.model, (5, 7, 8, 9)))
    trainer = t_trainer.Trainer(cfg, ds, T_EXT, workdir=str(tmp_path), device="cpu")
    state = trainer.train(max_steps=2)
    assert state.step == 2
    assert t_ckpt.all_steps(trainer.ckpt_dir) == [1, 2]
    saved = t_ckpt.restore(trainer.ckpt_dir, 2)
    assert saved["step"] == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k

    trainer2 = t_trainer.Trainer(cfg, ds, T_EXT, workdir=str(tmp_path), device="cpu")
    restored = trainer2.restore_or_init()
    assert restored.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    assert restored.optimizer.state_dict()["state"].keys() == state.optimizer.state_dict()["state"].keys()
    state2 = trainer2.train(max_steps=3)
    assert state2.step == 3 and t_ckpt.latest_step(trainer.ckpt_dir) == 3
    recs = read_scalars(str(tmp_path / "summaries"))
    assert [r["step"] for r in recs] == [1, 2, 3]
    for r in recs:
        assert all(np.isfinite(r[k]) for k in ("total", "grad_norm", "step_ms"))
    assert not torch.equal(state2.model.state_dict()["rpn_head.fc1.weight"],
                           saved["model"]["rpn_head.fc1.weight"])
