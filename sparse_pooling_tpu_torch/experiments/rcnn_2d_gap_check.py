"""Train two detector arms on one tree and decompose their IoU by box axis.

    python -m sparse_pooling_tpu_torch.experiments.rcnn_2d_gap_check \
        [--steps 2000] [--scene cars] [--device cuda] [--arms avod,rcnn]

Port of ``tools/rcnn_2d_gap_check.py``. Trains each arm at the ``unittest``
lattice (small enough for the CPU) on the same synthetic car scenes
through ``Trainer``, evaluates held-out moderate AP through ``Evaluator``,
and runs ``experiments.analyze_2d_gap`` over every arm's prediction dir:
the matched detections' IoUs with one box parameter group taken from the
ground truth, which names the regression axis that costs 2D or 3D AP.

By default the arms are the JAX tool's: the AVOD-style detector and the
FusionRcnn family (``--arms avod,rcnn``, both with the ``unittest`` stage-2
default ``box_4c``). An arm is ``ARCH[:BOX_REP[:BEV_ROI_STRIDE]]``: e.g.
``--arms rcnn:offsets,rcnn:box_4c`` sets ``avod.box_rep``, and
``--arms avod,avod:box_4c:4`` holds exact stage-2 crops against strided ones.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile


def arm_model(model, arm: str):
    """``model`` (any package's ``ModelConfig``) with the arm's architecture,
    and its ``avod.box_rep`` and ``avod.bev_roi_stride`` where given."""

    parts = arm.split(":")
    avod = dict(zip(("box_rep", "bev_roi_stride"), parts[1:]))
    if "bev_roi_stride" in avod:
        avod["bev_roi_stride"] = int(avod["bev_roi_stride"])
    return dataclasses.replace(model, architecture=parts[0], avod=dataclasses.replace(model.avod, **avod))


def arm_config(root: str, workdir: str, steps: int, arm: str):
    """The JAX tool's training config for ``arm`` over the tree at ``root``."""

    from sparse_pooling_tpu_torch.configs import unittest_config
    from sparse_pooling_tpu_torch.configs.config import EvalConfig, OptimizerConfig

    base = unittest_config(dataset_root=root)
    return dataclasses.replace(
        base,
        checkpoint_name="gap_" + arm.replace(":", "_"),
        experiments_dir=f"{workdir}/exp",
        model=arm_model(base.model, arm),
        train=dataclasses.replace(
            base.train, batch_size=4, max_iterations=steps, checkpoint_interval=steps,
            summary_interval=max(steps // 10, 1),
            optimizer=OptimizerConfig(initial_lr=8e-4, decay_steps=steps // 2, decay_rate=0.5)),
        eval=EvalConfig(kitti_score_threshold=0.05, batch_size=4, ap_n_points=40),
        dataset=dataclasses.replace(base.dataset, split="train", aug_flip=True, shuffle=True),
    )


def train_and_evaluate(cfg, device: str, seed: int = 0):
    """Trains ``cfg`` from init seed ``seed``, evaluates its checkpoints on
    the val split -> {"ap": the last checkpoint's AP, "step", "pred_dir"}."""

    from sparse_pooling_tpu_torch.runtime.evaluator import Evaluator
    from sparse_pooling_tpu_torch.runtime.trainer import Trainer

    Trainer(cfg, device=device, seed=seed).train()
    ev = Evaluator(dataclasses.replace(cfg, dataset=dataclasses.replace(cfg.dataset, split="val")), device=device)
    results = ev.repeated_checkpoint_run(max_wait=0)
    thresh = cfg.eval.kitti_score_threshold
    return {"ap": results[-1]["ap"], "step": results[-1]["step"],
            "pred_dir": os.path.join(ev.workdir, "predictions", "kitti_native_eval", f"{thresh:g}",
                                     str(results[-1]["step"]), "data")}


def main(argv=None):
    """Runs the check; returns {arm: train_and_evaluate's result}."""

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--train_frames", type=int, default=24)
    p.add_argument("--val_frames", type=int, default=8)
    p.add_argument("--scene", default="cars")
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("--arms", default="avod,rcnn", help="comma list of ARCH[:BOX_REP[:BEV_ROI_STRIDE]]")
    args = p.parse_args(argv)

    from sparse_pooling_tpu_torch.data import synthetic
    from sparse_pooling_tpu_torch.experiments import analyze_2d_gap

    workdir = args.workdir or tempfile.mkdtemp(prefix="spt_rcnn_gap_")
    root = f"{workdir}/kitti"
    n_total = args.train_frames + args.val_frames
    if not os.path.exists(os.path.join(root, "train.txt")):
        synthetic.write_kitti_tree(root, num_frames=n_total, n_ground=2048, n_obj=512,
                                   val_frames=tuple(range(args.train_frames, n_total)), scene=args.scene)

    runs = {}
    for arm in args.arms.split(","):
        cfg = arm_config(root, workdir, args.steps, arm)
        print(f"\n[{arm}] training {args.steps} steps...")
        run = runs[arm] = train_and_evaluate(cfg, args.device)
        ap = run["ap"]["Car"]
        print(f"[{arm}] held-out moderate Car AP (40-pt): "
              + " ".join(f"{m}={ap[m]['moderate']:.3f}" for m in ("2d", "bev", "3d", "aos")))

    gt_dir = os.path.join(root, "training", "label_2")
    print("\n[decomposition] per-axis counterfactual IoUs (see experiments/analyze_2d_gap.py)")
    analyze_2d_gap.main([gt_dir, *(run["pred_dir"] for run in runs.values())])
    print(f"\nworkdir: {workdir}")
    return runs


if __name__ == "__main__":
    main()
