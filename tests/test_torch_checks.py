"""The port's learning checks and the unittest preset over a KITTI tree, on
the CPU, against the JAX package.

* each check's configs (the ``Trainer``'s, one a seed, and the
  ``Evaluator``'s) equal the JAX check's for the same arguments: both
  checks run with stub ``Trainer`` and ``Evaluator`` classes that record
  their config, so no training runs;
* ``KittiDataset`` with the ``unittest`` preset (the tree's 375x1242 images
  onto its 48x160 canvas through the host resize) equals JAX's, sample by
  sample and batch by batch, with and without augmentation;
* the port's ``overfit_check`` end to end for 2 steps (``--roi exact`` and
  ``fast``): trees, training, the sweep of both checkpoints, the native AP;
  ``people_check`` for 2 steps; ``run_training --preset unittest`` on a tree.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports flax

import sparse_pooling_tpu  # noqa: E402
from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.configs import unittest_config as j_unittest_config  # noqa: E402
from sparse_pooling_tpu.data import dataset as j_dataset  # noqa: E402
from sparse_pooling_tpu.data import synthetic as j_syn  # noqa: E402
from sparse_pooling_tpu.experiments import cars_check as j_cars  # noqa: E402
from sparse_pooling_tpu.experiments import overfit_check as j_overfit  # noqa: E402
from sparse_pooling_tpu.experiments import people_check as j_people  # noqa: E402
from sparse_pooling_tpu.experiments import people_prod_check as j_prod  # noqa: E402
from sparse_pooling_tpu_torch.configs import config as tcfg_mod  # noqa: E402
from sparse_pooling_tpu_torch.configs import unittest_config  # noqa: E402
from sparse_pooling_tpu_torch.data import dataset as t_dataset  # noqa: E402
from sparse_pooling_tpu_torch.experiments import cars_check, check_utils  # noqa: E402
from sparse_pooling_tpu_torch.experiments import overfit_check, people_check, people_prod_check  # noqa: E402
from sparse_pooling_tpu_torch.experiments import run_training  # noqa: E402


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """5 frames (4 training, 1 val) written by the JAX package."""

    root = str(tmp_path_factory.mktemp("checks_tree"))
    j_syn.write_kitti_tree(root, num_frames=5, n_ground=3000, n_obj=300, val_frames=(4,))
    return root


# ---------------------------------------------------------------- configs

def _stubs(classes_of):
    """Trainer and Evaluator stand-ins that record each config; the
    Evaluator's sweep returns one result whose every AP is 0.5."""

    seen = {"train": [], "eval": []}

    class Trainer:
        def __init__(self, cfg, *args, **kwargs):
            seen["train"].append(cfg)

        def train(self, *args, **kwargs):
            return None

    class Evaluator:
        def __init__(self, cfg, *args, **kwargs):
            seen["eval"].append(cfg)
            self.cfg = cfg

        def repeated_checkpoint_run(self, *args, **kwargs):
            ap = {m: {b: 0.5 for b in check_utils.BANDS} for m in check_utils.METRICS}
            return [{"step": 1, "ap": {c: ap for c in classes_of(self.cfg)}, "frames_per_sec": 1.0}]

    return seen, Trainer, Evaluator


def _as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


CASES = {
    "overfit": (j_overfit, overfit_check, [["--steps", "2500"], ["--steps", "7", "--roi", "fast"]]),
    "people": (j_people, people_check, [
        ["--steps", "300", "--train_frames", "2", "--val_frames", "1"],
        ["--steps", "9", "--train_frames", "2", "--val_frames", "2", "--voxel", "0.5", "--lr", "2e-3",
         "--scene", "people_hard", "--ap_points", "11"]]),
    "cars": (j_cars, cars_check, [
        ["--no_heading_audit"],
        ["--no_heading_audit", "--seed", "5", "--scene", "cars", "--steps", "30"],
        ["--no_heading_audit", "--preset", "rcnn_cars", "--seeds", "0,3", "--flip_head", "--s2_bev_stride",
         "4", "--s2_img_stride", "2", "--max_anchors", "4096", "--ang_weight", "2", "--rcnn_box_rep",
         "box_8c", "--eval_nms_size", "64", "--pre_top_k", "1000", "--pool_channels", "32", "--grad_clip",
         "10", "--checkpoint_interval", "500", "--batch", "2", "--lr", "1e-3", "--roi_quad", "2",
         "--ap_points", "11", "--steps", "10"]]),
    "people_prod": (j_prod, people_prod_check, [
        [], ["--roi_quad", "2", "--flip_head", "--seed", "3", "--batch", "2", "--steps", "40",
             "--ap_points", "11", "--lr", "1e-3"]]),
}


@pytest.mark.parametrize("check,case", [(k, i) for k, (_, _, cases) in CASES.items() for i in range(len(cases))])
def test_check_configs_match_jax(check, case, tree, tmp_path, monkeypatch):
    j_mod, t_mod, cases = CASES[check]
    argv = ["--workdir", str(tmp_path)] + cases[case]
    if check in ("cars", "people_prod"):
        argv += ["--dataset_root", tree]  # an existing tree: neither check writes one
    classes = lambda cfg: list(cfg.model.classes)  # noqa: E731
    j_seen, j_trainer, j_evaluator = _stubs(classes)
    t_seen, t_trainer, t_evaluator = _stubs(classes)
    monkeypatch.setattr(sparse_pooling_tpu, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr("sparse_pooling_tpu.runtime.trainer.Trainer", j_trainer)
    monkeypatch.setattr("sparse_pooling_tpu.runtime.evaluator.Evaluator", j_evaluator)
    monkeypatch.setattr("sparse_pooling_tpu_torch.runtime.trainer.Trainer", t_trainer)
    monkeypatch.setattr("sparse_pooling_tpu_torch.runtime.evaluator.Evaluator", t_evaluator)
    # --device= : the JAX check leaves its platform alone (the tests' CPU)
    j_mod.main(argv + ["--device="])
    t_mod.main(argv + ["--device", "cpu"])
    assert len(t_seen["train"]) == len(j_seen["train"]) >= 1
    assert len(t_seen["eval"]) == len(j_seen["eval"]) == len(j_seen["train"])
    for kind in ("train", "eval"):
        for got, want in zip(t_seen[kind], j_seen[kind]):
            assert _as_dict(got) == _as_dict(want)
            assert jcfg_mod.pipeline_config_from_dict(_as_dict(got)) == want
    if check in ("cars", "people_prod"):  # the summaries, less the port's device
        name = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
        assert len(name) == 1


def test_check_utils_match_jax():
    from sparse_pooling_tpu.experiments import check_utils as j_cu

    rng = np.random.RandomState(0)
    aps = [{c: {m: {b: float(rng.rand()) for b in check_utils.BANDS} for m in ("2d", "bev", "3d")}
            for c in ("Car", "Cyclist")} for _ in range(3)]
    assert check_utils.aggregate_aps(aps, ["Car", "Cyclist"]) == j_cu.aggregate_aps(aps, ["Car", "Cyclist"])
    results = [{"step": i, "ap": a} for i, a in enumerate(aps)]
    assert check_utils.best_result(results, ["Car", "Cyclist"]) is j_cu.best_result(results, ["Car", "Cyclist"])
    for seeds, seed in (("0,7", None), ("3", None), ("0,7", 4), ("", None)):
        assert check_utils.parse_seeds(seeds, seed) == j_cu.parse_seeds(seeds, seed)


# ---------------------------------------------------------------- the unittest preset over a tree

def test_unittest_preset_loads_the_tree_as_jax_does(tree):
    """The unittest preset's 48x160 canvas: the host resize, P2 scaled by
    (48 / 375, 160 / 1242), ``image_scale`` ones; samples and two epochs
    of shuffled, augmented batches equal to JAX's."""

    tcfg = unittest_config(dataset_root=tree)
    tcfg = dataclasses.replace(tcfg, dataset=dataclasses.replace(tcfg.dataset, aug_pca_jitter=True))
    jcfg = jcfg_mod.pipeline_config_from_dict(dataclasses.asdict(tcfg))
    ext = tcfg_mod.AreaExtents()
    tds = t_dataset.KittiDataset(tcfg.dataset, tcfg.model, ext)
    jds = j_dataset.KittiDataset(jcfg.dataset, jcfg.model, jcfg_mod.AreaExtents(**dataclasses.asdict(ext)))
    for sid in tds.sample_ids:
        for seed in (None, t_dataset.augment_seed(0, 1, sid)):
            got, want = tds.load_sample(sid, augment_seed=seed), jds.load_sample(sid, augment_seed=seed)
            assert got.image.shape == (48, 160, 3) and tuple(got.raw_image_hw) == (375, 1242)
            np.testing.assert_array_equal(got.image_scale, np.ones(2, np.float32))
            for a, b in zip(got.as_arrays(), want.as_arrays()):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    for epoch in (0, 1):
        for (ga, gids), (wa, wids) in zip(tds.batches(2, epoch), jds.batches(2, epoch)):
            assert gids == wids
            for a, b in zip(ga, wa):
                np.testing.assert_array_equal(a, b)
    assert j_unittest_config().model.image == jcfg.model.image


# ---------------------------------------------------------------- end to end on the CPU

@pytest.mark.parametrize("roi", ["exact", "fast"])
def test_overfit_check_runs_end_to_end(tmp_path, roi):
    results = overfit_check.main(["--steps", "2", "--roi", roi, "--device", "cpu", "--workdir", str(tmp_path)])
    assert [r["step"] for r in results] == [1, 2]
    work = tmp_path / "exp" / "overfit_check"
    for r in results:
        assert r["ap_backend"] == "native_cpp" and r["num_frames"] == 2
        assert all(math.isfinite(v) for m in r["ap"]["Car"].values() for v in m.values())
        assert json.loads((work / f"eval_{r['step']}.json").read_text())["step"] == r["step"]
        preds = work / "predictions" / "kitti_native_eval" / "0.05" / str(r["step"]) / "data"
        assert sorted(os.listdir(preds)) == ["000000.txt", "000001.txt"]
    cfg = json.loads((work / "pipeline_config.json").read_text())
    assert cfg["model"]["rpn"]["bev_roi_stride"] == (2 if roi == "fast" else 1)


def test_people_check_runs_end_to_end(tmp_path):
    results = people_check.main(["--steps", "2", "--train_frames", "4", "--val_frames", "2", "--device", "cpu",
                                 "--workdir", str(tmp_path)])
    assert [r["step"] for r in results] == [1, 2]
    for r in results:
        assert r["num_frames"] == 2 and set(r["ap"]) == {"Pedestrian", "Cyclist"}


def test_run_training_unittest_preset_on_a_tree(tree, tmp_path):
    state = run_training.main(["--preset", "unittest", "--dataset_root", tree, "--max_steps", "2",
                               "--batch_size", "2", "--device", "cpu", "--experiments_dir", str(tmp_path)])
    assert state.step == 2
    assert os.listdir(tmp_path / "unittest_pipeline" / "checkpoints")
