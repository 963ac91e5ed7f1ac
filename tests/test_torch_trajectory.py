"""Many training steps of the port against the JAX package's own, on the CPU.

A single step's losses and gradients match (``test_torch_train.py``,
``test_torch_rcnn.py``); this holds a sequence of ``K`` steps, which also
exercises Adam's state across steps, the staircase decay, the global-norm
clip and parameters that have already moved. Each side runs its own step
factory and optimizer: JAX's ``runtime.trainer.make_train_step`` with its
``Trainer``'s ``tx``, the port's ``make_train_step`` with its ``Trainer``'s
``build_optimizer``. Both start from JAX's ``Trainer.init_state(seed=0)``
(carried over by ``weights.from_flax``) and take the same batches: each
package's ``KittiDataset.batches`` over one tree from the JAX writer, with
augmentation on and shuffled epochs (the arrays are asserted equal).

The draws are JAX's ``Trainer.train``'s: ``rng, step_rng = split(rng)`` each
step from the init key, and inside the step ``r_fwd, r_loss =
split(step_rng)``; the port's step gets the minibatch priorities drawn from
``r_loss`` through ``noise=`` (``test_torch_train._loss_noise``). Path drop
and dropout are off, because their draws cannot be matched across the two
packages.

The ``unittest`` preset's lattice in f32 (88x100 BEV, 48x160 canvas) at
batch 2, ``K`` = 12 steps of Adam at ``cars_check``'s rate 8e-4 with the
rate halved at step 6 (``decay_steps`` 6, staircase). Arms, one a file so
that one worker trains one: the AVOD-style detector with exact stage-2
crops (this file) and with ``avod.bev_roi_stride`` 4
(``test_torch_trajectory_strided.py``); ``rcnn_cars``'s family with
offsets (``test_torch_trajectory_rcnn.py``), box_4c
(``test_torch_trajectory_box4c.py``), and box_4c with ``grad_clip_norm``
10, which bites at this lattice (``test_torch_trajectory_clip.py``).

Compared: every step's loss terms and ``grad_norm`` (relative 1e-3; the
positive counts equal; no jump of two orders of magnitude in one step, the
mark of a fault rather than of f32 rounding carried forward), the proposal
sets every step (as many valid a frame, each box within 1e-5 of the largest
coordinate of its nearest in the other set: a different NMS pick moves a
box by metres), the learning rate,
and after step ``K`` every parameter and both Adam moments of each
(relative L2 within 5e-3). The measured deviations stand beside each bound.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
pytest.importorskip("flax")  # the JAX package imports flax

from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.data import dataset as j_dataset  # noqa: E402
from sparse_pooling_tpu.data import synthetic as j_syn  # noqa: E402
from sparse_pooling_tpu.models import pipeline as j_pl  # noqa: E402
from sparse_pooling_tpu.runtime import trainer as j_trainer  # noqa: E402
from sparse_pooling_tpu_torch import weights  # noqa: E402
from sparse_pooling_tpu_torch.configs import unittest_config  # noqa: E402
from sparse_pooling_tpu_torch.configs import config as tcfg_mod  # noqa: E402
from sparse_pooling_tpu_torch.data import dataset as t_dataset  # noqa: E402
from sparse_pooling_tpu_torch.models import pipeline as t_pl  # noqa: E402
from sparse_pooling_tpu_torch.runtime import trainer as t_trainer  # noqa: E402
from test_torch_train import _loss_noise  # noqa: E402

K, DECAY_STEPS, BATCH = 12, 6, 2
TERMS = ("total", "rpn_objectness", "rpn_regression", "cls", "reg", "orientation", "flip")
COUNTS = ("num_rpn_pos", "num_s2_pos")
# Bounds, from the measured deviations of the five arms (largest over the arms):
LOSS_TOL = 1e-3  # relative, each loss term and grad_norm, every step (measured 9.1e-5)
BOX_TOL = 1e-5  # each valid proposal's coordinates, of the largest (measured 9.8e-7)
# relative L2 of each parameter and of each Adam moment after step K (measured 1.9e-3 and
# 1.2e-3, conv biases whose gradients are near Adam's eps: the update m / (sqrt(v) + eps)
# turns their few-ulp gradient differences into lr-sized ones)
STATE_TOL = 5e-3
T_EXT = tcfg_mod.AreaExtents()
J_EXT = jcfg_mod.AreaExtents()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Six training frames of car scenes (three batches an epoch) from the
    JAX writer."""

    root = str(tmp_path_factory.mktemp("traj_tree"))
    j_syn.write_kitti_tree(root, num_frames=7, n_ground=2048, n_obj=512, val_frames=(6,), scene="cars")
    return root


def arm_config(root, architecture="avod", box_rep="box_4c", bev_roi_stride=1, grad_clip=0.0):
    """The ``unittest`` preset over ``root`` with the arm's stage 2, Adam at
    8e-4 halved every ``DECAY_STEPS``, augmentation on, path drop and
    dropout off, on one device (no JAX mesh over the test's CPU devices)."""

    cfg = unittest_config(dataset_root=root)
    r = dataclasses.replace
    model = r(cfg.model, architecture=architecture,
              avod=r(cfg.model.avod, box_rep=box_rep, bev_roi_stride=bev_roi_stride, keep_dropout_prob=1.0),
              path_drop=r(cfg.model.path_drop, enabled=False))
    return r(cfg, model=model,
             train=r(cfg.train, batch_size=BATCH, max_iterations=K, data_parallel=False,
                     optimizer=tcfg_mod.OptimizerConfig(initial_lr=8e-4, decay_steps=DECAY_STEPS, decay_rate=0.5,
                                                        staircase=True, grad_clip_norm=grad_clip)),
             dataset=r(cfg.dataset, aug_flip=True, aug_pca_jitter=True, shuffle=True))


def _batches(tds, jds):
    """K batches of each package's ``batches`` over successive epochs, as
    both trainers draw them, asserted equal."""

    pairs = ((t, j) for epoch in itertools.count()
             for t, j in zip(tds.batches(BATCH, epoch, augment=True), jds.batches(BATCH, epoch, augment=True)))
    out = []
    for (ta, tids), (ja, jids) in itertools.islice(pairs, K):
        assert tids == jids
        for a, b in zip(ta, ja):
            if a is None or b is None:
                assert a is None and b is None
            else:
                np.testing.assert_array_equal(a, b)
        out.append((ta, ja))
    return out


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` inside an optax chain's state."""

    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def run_trajectory(cfg, tmp_path):
    """K steps of both packages -> per-step records and the final states."""

    jcfg = jcfg_mod.pipeline_config_from_dict(dataclasses.asdict(cfg))
    jds = j_dataset.KittiDataset(jcfg.dataset, jcfg.model, J_EXT)
    tds = t_dataset.KittiDataset(cfg.dataset, cfg.model, T_EXT)
    batches = _batches(tds, jds)

    with pytest.MonkeyPatch.context() as mp:  # no summaries are written: spare importing tensorboard
        mp.setattr(j_trainer, "SummaryWriter", lambda logdir: None)
        jtr = j_trainer.Trainer(jcfg, dataset=jds, extents=J_EXT, workdir=str(tmp_path / "jax"))
    jstate = jtr.init_state(seed=0)
    jstep = j_trainer.make_train_step(jtr.model, jtr.tx, jtr.anchors_static, jcfg, J_EXT)
    jforward = jax.jit(lambda params, batch, key: j_pl.forward_batch_fn(
        jtr.model, params, batch, jtr.anchors_static, jcfg.model, J_EXT, True, key))

    ttr = t_trainer.Trainer(cfg, dataset=tds, extents=T_EXT, workdir=str(tmp_path / "torch"), device="cpu")
    tstate = ttr.init_state()
    tstate.model.load_state_dict(weights.from_flax(jax.tree.map(np.asarray, jstate.params), cfg.model),
                                 strict=True)
    tstep = t_trainer.make_train_step(tstate.model, tstate.optimizer, tstate.scheduler, ttr.anchors_static,
                                      cfg, T_EXT)
    seen = []
    forward = t_pl.forward_batch_fn

    def recording_forward(*args, **kwargs):
        out = forward(*args, **kwargs)
        seen.append({k: out[k].detach().clone() for k in ("proposals", "proposal_valid")})
        return out

    params, opt_state, rng = jstate.params, jstate.opt_state, jstate.rng
    steps = []
    mp = pytest.MonkeyPatch()
    mp.setattr(t_pl, "forward_batch_fn", recording_forward)
    try:
        for tarrays, jarrays in batches:
            jbatch = j_pl.RawSample(*(None if a is None else jnp.array(a) for a in jarrays))
            tbatch = t_pl.RawSample(*(None if a is None else torch.from_numpy(np.asarray(a)) for a in tarrays))
            rng, step_rng = jax.random.split(rng)  # Trainer.train's draws
            r_fwd, r_loss = jax.random.split(step_rng)  # make_train_step's loss_fn
            jout = jforward(params, jbatch, r_fwd)
            params, opt_state, jmetrics = jstep(params, opt_state, jbatch, step_rng)
            noise = _loss_noise(r_loss, BATCH, jout["anchors"].shape[1], jout["proposals"].shape[1])
            tmetrics = tstep(tbatch, None, noise=noise)
            steps.append({
                "jax": {k: float(v) for k, v in jmetrics.items()},
                "port": {k: float(v) for k, v in tmetrics.items()},
                "jax_proposals": np.asarray(jout["proposals"]),
                "jax_valid": np.asarray(jout["proposal_valid"]),
                "port_proposals": seen[-1]["proposals"].numpy(),
                "port_valid": seen[-1]["proposal_valid"].numpy(),
            })
    finally:
        mp.undo()
    assert len(seen) == K

    names = dict((p, n) for n, p in tstate.model.named_parameters())
    adam = _adam_state(opt_state)
    tmu, tnu = {}, {}
    for p, st in tstate.optimizer.state.items():
        tmu[names[p]], tnu[names[p]] = st["exp_avg"], st["exp_avg_sq"]
    return {
        "cfg": cfg, "steps": steps, "lr_jax": [float(_schedule(jcfg)(i)) for i in range(K)],
        "params": (weights.from_flax(jax.tree.map(np.asarray, params), cfg.model),
                   {n: p.detach() for n, p in tstate.model.named_parameters()}),
        "mu": (weights.from_flax(jax.tree.map(np.asarray, adam.mu), cfg.model), tmu),
        "nu": (weights.from_flax(jax.tree.map(np.asarray, adam.nu), cfg.model), tnu),
    }


def _schedule(jcfg):
    import optax

    oc = jcfg.train.optimizer
    return optax.exponential_decay(oc.initial_lr, oc.decay_steps, oc.decay_rate, staircase=oc.staircase)


# ---------------------------------------------------------------- measurement helpers

def loss_deviation(run):
    """-> [K] the largest relative deviation of a loss term or grad_norm at each step."""

    out = []
    for s in run["steps"]:
        out.append(max(abs(s["port"][k] - s["jax"][k]) / max(abs(s["jax"][k]), 1e-6)
                       for k in TERMS + ("grad_norm",)))
    return out


def proposal_deviation(run):
    """-> [K] the distance between the two packages' sets of valid proposals
    at each step, relative to the largest coordinate: each frame's boxes
    matched both ways to their nearest (largest coordinate difference) in
    the other set, so a reordering of near-tied picks is no difference."""

    out = []
    for s in run["steps"]:
        worst, scale = 0.0, 1.0
        for jp, jv, tp, tv in zip(s["jax_proposals"], s["jax_valid"], s["port_proposals"], s["port_valid"]):
            a, b = jp[jv].astype(np.float64), tp[tv].astype(np.float64)
            if len(a) == 0:
                continue
            scale = max(scale, np.abs(a).max())
            d = np.abs(a[:, None] - b[None]).max(-1)
            worst = max(worst, d.min(1).max(), d.min(0).max())
        out.append(float(worst / scale))
    return out


def state_deviation(pair):
    """-> {name: relative L2 of the port's tensor against JAX's}."""

    want, got = pair
    assert set(want) == set(got)
    out = {}
    for name, w in want.items():
        w64, g64 = w.double(), got[name].double()
        out[name] = float((g64 - w64).norm() / max(w64.norm(), 1e-12))
    return out


# ---------------------------------------------------------------- checks shared by the arms

def check_losses(run):
    dev = loss_deviation(run)
    assert max(dev) <= LOSS_TOL, f"per-step loss deviation {['%.1e' % d for d in dev]}"
    for s in run["steps"]:
        for k in COUNTS:
            assert s["port"][k] == s["jax"][k], k
    # a fault shows as a jump of orders of magnitude in one step, not as slow growth (a
    # step's deviation also follows its batch, so the jump is counted from the largest so far)
    for i in range(1, K):
        assert dev[i] <= max(100 * max(dev[:i]), 1e-5), f"deviation jumped to {dev[i]:.1e} at step {i + 1}"
    assert sum(s["jax"]["num_rpn_pos"] for s in run["steps"]) > 0


def check_proposals(run):
    for i, s in enumerate(run["steps"]):
        np.testing.assert_array_equal(s["port_valid"].sum(-1), s["jax_valid"].sum(-1), err_msg=f"step {i + 1}")
    dev = proposal_deviation(run)
    assert max(dev) <= BOX_TOL, f"per-step proposal deviation {['%.1e' % d for d in dev]}"


def check_schedule(run):
    lrs = [s["port"]["lr"] for s in run["steps"]]
    np.testing.assert_allclose(lrs, run["lr_jax"], rtol=1e-6)
    assert lrs[0] == pytest.approx(8e-4) and lrs[-1] == pytest.approx(4e-4)  # one decay inside the run


def check_state(run, which):
    dev = state_deviation(run[which])
    worst = max(dev, key=dev.get)
    assert dev[worst] <= STATE_TOL, f"{which} {worst}: relative L2 {dev[worst]:.2e}"


# ---------------------------------------------------------------- the arms, one a file

ARMS = {
    "exact": {},
    "strided": {"bev_roi_stride": 4},
    "offsets": {"architecture": "rcnn", "box_rep": "offsets"},
    "box_4c": {"architecture": "rcnn", "box_rep": "box_4c"},
    "box_4c_clip10": {"architecture": "rcnn", "box_rep": "box_4c", "grad_clip": 10.0},
}


def arm_fixture(name):
    """The module-scoped ``run`` fixture of one arm: each arm's file sets
    ``run = arm_fixture(...)`` and imports the checks below, so one worker
    trains one arm."""

    @pytest.fixture(scope="module")
    def run(tree, tmp_path_factory):
        return run_trajectory(arm_config(tree, **ARMS[name]), tmp_path_factory.mktemp(name))

    return run


run = arm_fixture("exact")


def test_losses_follow_jax_every_step(run):
    check_losses(run)


def test_proposals_equal_every_step(run):
    check_proposals(run)


def test_learning_rate_decays_as_optax(run):
    check_schedule(run)


@pytest.mark.parametrize("which", ["params", "mu", "nu"])
def test_state_matches_jax_after_k_steps(run, which):
    check_state(run, which)


def test_clip_bites_where_set(run):
    """Where ``grad_clip_norm`` is set, some step's norm (before the clip,
    both packages alike) is above it, so the arm holds clipped updates."""

    clip = run["cfg"].train.optimizer.grad_clip_norm
    norms = [s["jax"]["grad_norm"] for s in run["steps"]]
    assert max(norms) > clip if clip > 0 else min(norms) > 0


# ---------------------------------------------------------------- the measurement as a script

def main(argv=None):
    """Prints each arm's per-step deviations (the numbers behind the bounds),
    from the repo root:
    ``PYTHONPATH=. python tests/test_torch_trajectory.py [--arms exact,...] [--dtype bfloat16]``."""

    import argparse
    import pathlib
    import tempfile

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--arms", default=",".join(ARMS))
    p.add_argument("--dtype", default="float32", help="the backbone's compute dtype")
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    base = pathlib.Path(tempfile.mkdtemp(prefix="spt_trajectory_"))
    j_syn.write_kitti_tree(str(base / "tree"), num_frames=7, n_ground=2048, n_obj=512, val_frames=(6,), scene="cars")
    for name in args.arms.split(","):
        cfg = arm_config(str(base / "tree"), **ARMS[name])
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, backbone=dataclasses.replace(cfg.model.backbone, compute_dtype=args.dtype)))
        run = run_trajectory(cfg, base / name)
        fmt = lambda v: " ".join(f"{x:.1e}" for x in v)  # noqa: E731
        print(f"== {name} ({args.dtype})")
        for k in TERMS + ("grad_norm",):
            print(f"  {k:<15s}", fmt(abs(s["port"][k] - s["jax"][k]) / max(abs(s["jax"][k]), 1e-6)
                                     for s in run["steps"]))
        print("  loss, worst     ", fmt(loss_deviation(run)))
        print("  proposal sets   ", fmt(proposal_deviation(run)))
        print("  validity equal  ", [bool((s["port_valid"] == s["jax_valid"]).all()) for s in run["steps"]])
        print("  in order        ", fmt(float(np.abs(s["port_proposals"] - s["jax_proposals"]).max()
                                         / max(np.abs(s["jax_proposals"]).max(), 1.0)) for s in run["steps"]))
        print("  positives equal ", [all(s["port"][k] == s["jax"][k] for k in COUNTS) for s in run["steps"]])
        print("  grad_norm (JAX) ", " ".join(f"{s['jax']['grad_norm']:.3f}" for s in run["steps"]))
        for which in ("params", "mu", "nu"):
            dev = state_deviation(run[which])
            worst = max(dev, key=dev.get)
            print(f"  {which:<6s} worst {worst} {dev[worst]:.2e}")


if __name__ == "__main__":
    main()
