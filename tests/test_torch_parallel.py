"""The port's ``parallel/`` against the JAX package's, on the CPU.

* ``auto_mesh``: its ``(n_data, n_model)`` and its warning against the JAX
  ``auto_mesh`` over ``jax.devices()[:k]`` for a grid of batch, world and
  ``model_parallel``;
* ``param_sharding_rules``: the parameters it splits against the JAX rule's
  non-replicated paths, for cars, late and deep fusion and ``rcnn_cars``;
* the tensor-parallel ``Stage2Head`` on 2 gloo ranks: outputs and every
  gradient within 1e-6 of the unsharded head;
* ``dryrun_multichip(4)``: data 2 x model 2, 3 steps of the production
  ``Trainer`` against one process: losses at rtol 1e-5, final parameters at
  rtol 1e-3 / atol 1e-5 (the JAX test's tolerances);
* one data-parallel step on 2 ranks, the global sampling noise sliced per
  rank: its loss and gradients against ``jax.value_and_grad`` of the
  reference loss (1e-4, as ``tests/test_torch_train.py``);
* a step's losses and gradients do not depend on the point bucket (a rank
  stacks its rows at its own points' bucket);
* a data x model checkpoint at step 2 restored into a one-rank ``Trainer``,
  whose step 3 equals the mesh's resumed step 3;
* the 2-rank ``Evaluator``'s files hold the one-rank sweep's frames, rows
  and classes, their numbers within 1e-4 px (2D box) and 1e-5, with AP
  equal.

Each multi-process test runs its ranks through ``parallel.launch.spawn``:
a deadline, and a parent that kills the survivors of a failed rank.
"""

import dataclasses
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
pytest.importorskip("flax")  # the JAX package imports flax

from jax.sharding import PartitionSpec  # noqa: E402

from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.models import pipeline as j_pl  # noqa: E402
from sparse_pooling_tpu.parallel import mesh as j_mesh  # noqa: E402
from sparse_pooling_tpu_torch import weights  # noqa: E402
from sparse_pooling_tpu_torch.data import synthetic  # noqa: E402
from sparse_pooling_tpu_torch.models import draws  # noqa: E402
from sparse_pooling_tpu_torch.models import pipeline as t_pl  # noqa: E402
from sparse_pooling_tpu_torch.parallel import dryrun, launch  # noqa: E402
from sparse_pooling_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from sparse_pooling_tpu_torch.runtime import checkpoint as t_ckpt  # noqa: E402
from sparse_pooling_tpu_torch.runtime.summary import read_scalars  # noqa: E402
from sparse_pooling_tpu_torch.runtime.trainer import Trainer  # noqa: E402
from test_torch_rcnn import rcnn_parity_config  # noqa: E402
from test_torch_train import T_EXT, _frames, _loss_noise, _np_tree, parity_config  # noqa: E402

import torch_parallel_workers as workers  # noqa: E402

r = dataclasses.replace
SPAWN_TIMEOUT_S = 240.0


# ---------------------------------------------------------------- auto_mesh

MESH_GRID = [  # (batch, world, model_parallel)
    (4, 8, 1), (6, 8, 1), (5, 8, 1), (4, 8, 2), (1, 8, 1), (8, 8, 1), (3, 4, 2), (2, 2, 2), (7, 4, 1),
    (1, 1, 1), (4, 2, 1), (12, 8, 2),
]


def _messages(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in rec]


@pytest.mark.parametrize("batch,world,n_model", MESH_GRID)
def test_auto_mesh_matches_jax(batch, world, n_model):
    want, want_msgs = _messages(lambda: j_mesh.auto_mesh(batch, n_model, devices=jax.devices()[:world]))
    got, got_msgs = _messages(lambda: t_mesh.auto_mesh(batch, n_model, world_size=world, rank=0))
    assert got_msgs == want_msgs
    if want is None:
        assert got is None
        return
    assert got.shape == dict(zip(want.axis_names, want.devices.shape))
    # the global rank of each mesh position is JAX's reshape(n_data, n_model) order
    for rank in range(got.size):
        pos = t_mesh.make_mesh(got.n_data, got.n_model, world_size=world, rank=rank)
        assert want.devices[pos.data_index, pos.model_index] == jax.devices()[rank]
    outside = t_mesh.make_mesh(got.n_data, got.n_model, world_size=world, rank=world - 1)
    assert outside.member == (got.size == world)


def test_batch_rows_split_the_batch_in_data_order():
    rows = [t_mesh.batch_rows(t_mesh.make_mesh(2, 2, world_size=4, rank=k), 6) for k in range(4)]
    assert rows == [slice(0, 3), slice(0, 3), slice(3, 6), slice(3, 6)]
    assert t_mesh.batch_rows(None, 5) == slice(0, 5)
    with pytest.raises(ValueError, match="does not split"):
        t_mesh.batch_rows(t_mesh.make_mesh(2, 1, world_size=2, rank=0), 5)


def test_batch_rows_draws_equal_the_whole_batch_draws():
    """``draws.BatchRows``: each rank's rows of a draw at the global shape,
    from a generator seeded as the others'; a plain generator is unchanged."""

    whole = torch.rand((6, 5), generator=torch.Generator().manual_seed(4))
    parts = [draws.rand((3, 5), draws.BatchRows(torch.Generator().manual_seed(4), s, 6))
             for s in (slice(0, 3), slice(3, 6))]
    assert torch.equal(torch.cat(parts), whole)
    assert torch.equal(draws.rand((6, 5), torch.Generator().manual_seed(4)), whole)
    with pytest.raises(ValueError, match="hold 3 rows"):
        draws.rand((2, 5), draws.BatchRows(torch.Generator(), slice(0, 3), 6))


# ---------------------------------------------------------------- sharding rules

def _family_config(family):
    if family == "rcnn_cars":
        return rcnn_parity_config()
    cfg = parity_config()
    if family == "cars":
        return cfg
    return r(cfg, avod=r(cfg.avod, fusion_type=family, fusion_method="concat" if family == "deep" else "mean"))


@pytest.mark.parametrize("family", ["cars", "late", "deep", "rcnn_cars"])
def test_param_sharding_rules_match_jax(family):
    cfg = _family_config(family)
    jcfg = jcfg_mod.pipeline_config_from_dict({"model": dataclasses.asdict(cfg)}).model
    jext = jcfg_mod.AreaExtents(**dataclasses.asdict(T_EXT))
    jmodel = j_pl.make_model(jcfg, jext)
    anchors = jnp.array(j_pl.static_anchor_grid(jcfg, jext))
    frame = _frames(cfg, (2,))[0]
    raw = j_pl.RawSample(**{k: jnp.array(frame[k]) for k in j_pl.RawSample._fields})

    def init(key):
        inputs = j_pl.build_model_inputs(raw, anchors, jnp.ones((2,), jnp.float32), jcfg, jext)
        return jmodel.init({"params": key, "dropout": key}, inputs, train=False)

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    want = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        if j_mesh.param_sharding_rules("/".join(["params", *keys]), leaf.shape) != PartitionSpec():
            want.add(".".join(keys[:-1] + ["weight" if keys[-1] == "kernel" else keys[-1]]))
    model = t_pl.make_model(cfg, T_EXT, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    got = set(t_mesh.sharded_names(names))
    assert got == want and got
    assert all(t_mesh.param_sharding_rules(f"module.{n}") == t_mesh.param_sharding_rules(n) for n in names)
    # a shard and its gather cover the full tensor
    sd = model.state_dict()
    parts = [t_mesh.shard_params(sd, t_mesh.make_mesh(1, 2, world_size=2, rank=k)) for k in range(2)]
    for n in got:
        assert torch.equal(torch.cat([p[n] for p in parts]), sd[n])
        assert parts[0][n].shape[0] * 2 == sd[n].shape[0]


# ---------------------------------------------------------------- tensor-parallel head

TP_CASES = [("early", "mean", 1.0), ("early", "mean", 0.5), ("late", "mean", 0.5), ("deep", "concat", 0.5),
            ("single", "mean", 0.5)]


@pytest.fixture(scope="module")
def tp_head():
    return launch.spawn(workers.tp_head_rank, 2, (TP_CASES,), timeout_s=SPAWN_TIMEOUT_S, threads=1)


@pytest.mark.parametrize("case", TP_CASES, ids=["-".join(map(str, c)) for c in TP_CASES])
def test_tensor_parallel_stage2_head_matches_the_unsharded_head(tp_head, case):
    key = "-".join(map(str, case))
    for rank, errs in enumerate(tp_head):
        e = errs[key]
        assert e["shape_fc1"][0] == 8, e  # 16 output features over 2 model ranks
        for what in ("outputs", "inputs", "params"):
            assert e[what] <= 1e-6, f"rank {rank} {key}: {what} differ by {e[what]:.3e}"


# ---------------------------------------------------------------- the trainer on a mesh

def test_dryrun_multichip_matches_one_process():
    out = dryrun.dryrun_multichip(4, steps=3, timeout_s=SPAWN_TIMEOUT_S)
    assert out["mesh"] == {"data": 2, "model": 2}
    assert out["fc1_shard"][0] * 2 == out["single_state"]["model"]["stage2_head.fc1.weight"].shape[0]
    np.testing.assert_allclose(out["sharded_losses"], out["single_losses"], rtol=1e-5)
    got, want = out["sharded_state"], out["single_state"]
    assert got["step"] == want["step"] == 3 and got["model"].keys() == want["model"].keys()
    for k, v in want["model"].items():
        np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(), rtol=1e-3, atol=1e-5, err_msg=k)
    # Adam's moments gathered to the single-card layout
    for i, st in want["optimizer"]["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(got["optimizer"]["state"][i][name].numpy(), st[name].numpy(),
                                       rtol=1e-3, atol=1e-5)


def test_data_parallel_step_matches_jax():
    """One step on 2 data ranks (a frame each) with the global batch's JAX
    sampling noise sliced per rank: the mean of the ranks' loss terms and the
    averaged gradients against ``jax.value_and_grad`` of the reference loss."""

    cfg = parity_config()
    jcfg = jcfg_mod.pipeline_config_from_dict({"model": dataclasses.asdict(cfg)}).model
    jext = jcfg_mod.AreaExtents(**dataclasses.asdict(T_EXT))
    frames = _frames(cfg, (2, 3))
    jmodel = j_pl.make_model(jcfg, jext)
    janchors = jnp.array(j_pl.static_anchor_grid(jcfg, jext))
    jbatch = j_pl.RawSample(**{k: jnp.array(np.stack([f[k] for f in frames])) for k in j_pl.RawSample._fields})

    def init(key, batch):
        raw0 = jax.tree.map(lambda x: x[0], batch)
        inputs = j_pl.build_model_inputs(raw0, janchors, jnp.ones((2,), jnp.float32), jcfg, jext)
        return jmodel.init({"params": key, "dropout": key}, inputs, train=False)

    def loss_fn(params, batch, key):
        r_fwd, r_loss = jax.random.split(key)
        out = j_pl.forward_batch_fn(jmodel, params, batch, janchors, jcfg, jext, True, r_fwd)
        losses = j_pl.loss_batch(out, batch, r_loss, jcfg, jext)
        return losses["total"], (losses, out["anchors"].shape[1], out["proposals"].shape[1])

    params = jax.jit(init)(jax.random.PRNGKey(0), jbatch)
    key = jax.random.PRNGKey(11)
    (_, (jlosses, a, p)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, jbatch, key)
    noise = _loss_noise(jax.random.split(key)[1], len(frames), a, p)
    ranks = launch.spawn(workers.dp_step_rank, 2,
                         (cfg, T_EXT, weights.from_flax(_np_tree(params), cfg), frames, noise),
                         timeout_s=SPAWN_TIMEOUT_S, threads=2)
    for term in ("total", "rpn_objectness", "rpn_regression", "cls", "reg", "orientation", "flip"):
        got = np.mean([rk["losses"][term] for rk in ranks])
        np.testing.assert_allclose(got, float(jlosses[term]), atol=1e-4, rtol=1e-4, err_msg=term)
    want = weights.from_flax(_np_tree(jgrads), cfg)
    grads = ranks[0]["grads"]
    assert set(grads) == set(want)
    for name, w in want.items():
        scale = max(w.abs().max().item(), 1e-8)
        err = (grads[name] - w).abs().max().item()
        assert err <= 1e-4 * scale, f"{name}: max abs err {err:.3e} > 1e-4 * {scale:.3e}"


def test_a_step_does_not_depend_on_the_point_bucket():
    """A data-parallel rank stacks its rows at the bucket of its own points,
    which may be smaller than the global batch's: the same frames padded to
    twice their points give the same losses and gradients, bit for bit."""

    from sparse_pooling_tpu_torch.models import pipeline as pl

    cfg = parity_config()
    frames = _frames(cfg, (2, 3))
    model = pl.make_model(cfg, T_EXT, device="cpu")
    weights.init_like_flax(model, seed=0)
    anchors = pl.static_anchor_grid(cfg, T_EXT, device="cpu")

    def step(frs):
        batch = pl.stack_frames(frs, device="cpu")
        g = torch.Generator().manual_seed(5)
        noise = (torch.rand((2, cfg.anchors.max_anchors), generator=g),
                 torch.rand((2, cfg.rpn.train_nms_size), generator=g))
        losses = pl.loss_batch(pl.forward_batch_fn(model, batch, anchors, cfg, T_EXT, train=True), batch, cfg,
                               T_EXT, noise=noise)
        model.zero_grad()
        losses["total"].backward()
        return {k: v.item() for k, v in losses.items()}, {n: p.grad.clone() for n, p in model.named_parameters()}

    padded = [dict(f, points=np.concatenate([f["points"], np.zeros_like(f["points"])]),
                   points_mask=np.concatenate([f["points_mask"], np.zeros_like(f["points_mask"])]))
              for f in frames]
    (want, want_g), (got, got_g) = step(frames), step(padded)
    assert got == want
    assert all(torch.equal(got_g[n], want_g[n]) for n in want_g)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """A tree of 2 training and 5 val frames; 4 ranks (data 2 x model 2)
    train 2 steps, then a fresh mesh trainer resumes and takes step 3."""

    base = tmp_path_factory.mktemp("mesh_run")
    root = str(base / "kitti")
    synthetic.write_kitti_tree(root, num_frames=7, n_ground=512, n_obj=64, val_frames=range(2, 7))
    cfg = dryrun.dryrun_config(root, str(base / "experiments"), 2, 2)
    ranks = launch.spawn(workers.mesh_train_resume_rank, 4, (cfg, 2, 3), timeout_s=SPAWN_TIMEOUT_S, threads=1)
    workdir = os.path.join(cfg.experiments_dir, cfg.checkpoint_name)
    return {"cfg": cfg, "root": root, "workdir": workdir, "ranks": ranks, "base": base}


def test_mesh_checkpoint_resumes_on_one_rank(mesh_run):
    """The mesh's step-2 checkpoint (the single-card layout) loads into a
    one-process ``Trainer``, whose step 3 equals the mesh's resumed step 3
    (both resume with the generator seeded anew)."""

    cfg, workdir = mesh_run["cfg"], mesh_run["workdir"]
    assert all(rk["mesh"] == {"data": 2, "model": 2} and rk["step"] == 3 for rk in mesh_run["ranks"])
    assert t_ckpt.all_steps(os.path.join(workdir, "checkpoints")) == [1, 2, 3]
    one = str(mesh_run["base"] / "one_rank")
    os.makedirs(os.path.join(one, "checkpoints"))
    shutil.copytree(os.path.join(workdir, "checkpoints", "2"), os.path.join(one, "checkpoints", "2"))
    single = Trainer(r(cfg, train=r(cfg.train, data_parallel=False)), workdir=one, device="cpu")
    state = single.train(max_steps=3)
    assert state.step == 3 and single.mesh is None
    mesh_rec, one_rec = read_scalars(os.path.join(workdir, "summaries"))[-1], read_scalars(f"{one}/summaries")[-1]
    assert mesh_rec["step"] == one_rec["step"] == 3
    for k in ("total", "rpn_objectness", "cls", "grad_norm"):
        np.testing.assert_allclose(one_rec[k], mesh_rec[k], rtol=1e-5, err_msg=k)
    got = t_ckpt.restore(os.path.join(workdir, "checkpoints"), 3)["model"]
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-5, err_msg=k)


def _prediction_files(workdir, cfg, step):
    d = os.path.join(workdir, "predictions", "kitti_native_eval", f"{cfg.eval.kitti_score_threshold:g}",
                     str(step), "data")
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def _rows(text: bytes):
    """A KITTI txt's rows: (the type, truncation and occlusion fields, the
    13 numbers from alpha to the score)."""

    parts = [line.split() for line in text.decode().splitlines() if line.strip()]
    return [p[:3] for p in parts], np.array([[float(v) for v in p[3:]] for p in parts]).reshape(-1, 13)


# A rank's rows against one process's. A rank's calls take half the batch
# of one process's, and the CPU's convolution and matrix kernels sum in an
# order that depends on the batch a call gets and on the instruction set
# they pick (oneDNN's ISA): one process's sweeps at eval batch 1 and 2 part
# by one f32 ulp in a box, which the projection magnifies to 3e-5 px in a 2D
# box, and another CPU can draw that line between 2 and 4 (one run of this
# test on another host gave 8e-6 px). So the numbers, printed at 1e-6, are
# held to 1e-4 px (2D box) and 1e-5 (the rest)
ROW_ATOL_2D, ROW_ATOL = 1e-4, 1e-5


def test_two_rank_evaluator_writes_the_one_rank_files(mesh_run):
    """The 2-rank sweep of the mesh's step-3 checkpoint (eval batch 4 over 5
    val frames: the tail batch of 1 padded, so rank 1's rows of it are all
    padding) writes the one-rank sweep's files: the same frames, rows and
    classes, the numbers within ``ROW_ATOL_2D`` / ``ROW_ATOL``; AP equal."""

    cfg = mesh_run["cfg"]
    ecfg = r(cfg, dataset=r(cfg.dataset, split="val"), eval=r(cfg.eval, batch_size=4, data_parallel=True))
    two = str(mesh_run["base"] / "eval_two")
    one = str(mesh_run["base"] / "eval_one")
    for w in (two, one):
        shutil.copytree(os.path.join(mesh_run["workdir"], "checkpoints"), os.path.join(w, "checkpoints"))
    ranks = launch.spawn(workers.evaluate_rank, 2, (ecfg, two, 3), timeout_s=SPAWN_TIMEOUT_S, threads=2)
    # the one-rank sweep runs in a spawned process too, at the same intra-op
    # thread count: the CPU's convolutions split their sums by thread count
    (want,) = launch.spawn(workers.evaluate_rank, 1, (ecfg, one, 3), timeout_s=SPAWN_TIMEOUT_S, threads=2)
    assert want["mesh"] is None and all(rk["mesh"] == {"data": 2, "model": 1} for rk in ranks)
    got_files, want_files = _prediction_files(two, ecfg, 3), _prediction_files(one, ecfg, 3)
    assert sorted(got_files) == [f"{i:06d}.txt" for i in range(2, 7)]
    for name, text in want_files.items():
        (got_ids, got_num), (want_ids, want_num) = _rows(got_files[name]), _rows(text)
        assert got_ids == want_ids and got_num.shape == want_num.shape, name
        np.testing.assert_allclose(got_num[:, 1:5], want_num[:, 1:5], rtol=0, atol=ROW_ATOL_2D, err_msg=name)
        np.testing.assert_allclose(got_num[:, [0, *range(5, 13)]], want_num[:, [0, *range(5, 13)]], rtol=0,
                                   atol=ROW_ATOL, err_msg=name)
    res, ref = ranks[0]["result"], want["result"]
    assert ranks[1]["result"] == res and res["num_frames"] == ref["num_frames"] == 5
    assert res["ap"] == ref["ap"]
    assert os.path.exists(os.path.join(two, "eval_3.json"))
