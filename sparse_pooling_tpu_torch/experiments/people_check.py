"""Multi-class (Pedestrian + Cyclist) learning check on a HELD-OUT val split.

    python -m sparse_pooling_tpu_torch.experiments.people_check [--steps 3000] \
        [--train_frames 12] [--val_frames 4] [--device cuda]

Port of ``sparse_pooling_tpu.experiments.people_check``. Trains a
Pedestrian + Cyclist detector (the people preset's classes, anchor sizes
and IoU bands at the unittest lattice scale, a 0.4 m voxel and a 96x320
canvas that the host resize fills) on synthetic street scenes and evaluates
per-class AP on val frames the trainer never saw, through ``Trainer`` ->
checkpoints -> ``Evaluator`` -> KITTI txt -> native AP. Chance-level AP is
~0 (40-point recall sweep by default).
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

CLASSES = ("Pedestrian", "Cyclist")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--train_frames", type=int, default=12)
    p.add_argument("--val_frames", type=int, default=4)
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument(
        "--voxel", type=float, default=0.4,
        help="BEV voxel size (m). A pedestrian is ~0.7 m wide, one cell of the unittest "
        "preset's 0.8 m lattice, which caps BEV localization AP",
    )
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--scene", default="people", choices=("people", "people_hard"),
                   help="people_hard adds occlusion/truncation tiers + clutter")
    p.add_argument("--ap_points", type=int, default=40)
    return p.parse_args(argv)


def build_config(args, root: str, workdir: str):
    """The unittest preset with the people preset's classes, anchor sizes
    (stride 0.8 m) and IoU bands, ``--voxel`` BEV cells (padded to an even
    height for the fusion stride), a 96x320 canvas, batch 4, 3 checkpoints,
    flip augmentation and shuffle."""

    from sparse_pooling_tpu_torch.configs import unittest_config
    from sparse_pooling_tpu_torch.configs.config import (
        AnchorConfig,
        BevConfig,
        EvalConfig,
        ImageConfig,
        MiniBatchConfig,
        OptimizerConfig,
        TrainConfig,
    )
    from sparse_pooling_tpu_torch.configs.presets import CYCLIST_SIZE, PEDESTRIAN_SIZE

    base = unittest_config(dataset_root=root)
    grid_h = round((70.0 - 0.0) / args.voxel)
    pad_h = (-grid_h) % 2  # fusion_stride 2 divisibility
    return dataclasses.replace(
        base,
        checkpoint_name="people_check",
        experiments_dir=f"{workdir}/exp",
        model=dataclasses.replace(
            base.model,
            classes=CLASSES,
            bev=BevConfig(voxel_size=args.voxel, pad_h=pad_h),
            image=ImageConfig(height=96, width=320),
            anchors=AnchorConfig(sizes=(PEDESTRIAN_SIZE, CYCLIST_SIZE), stride=0.8, max_anchors=4096),
            mini_batch=MiniBatchConfig(
                rpn_batch_size=128, avod_batch_size=64,
                rpn_neg_iou=(0.0, 0.3), rpn_pos_iou=(0.35, 1.0),
                avod_neg_iou=(0.0, 0.45), avod_pos_iou=(0.45, 1.0),
            ),
        ),
        train=TrainConfig(
            batch_size=4, max_iterations=args.steps,
            checkpoint_interval=max(args.steps // 3, 1),
            summary_interval=max(args.steps // 15, 1),
            optimizer=OptimizerConfig(initial_lr=args.lr, decay_steps=args.steps // 2, decay_rate=0.5),
        ),
        eval=EvalConfig(kitti_score_threshold=0.05, batch_size=2, ap_n_points=args.ap_points),
        dataset=dataclasses.replace(base.dataset, split="train", aug_flip=True, aug_pca_jitter=False,
                                    shuffle=True),
    )


def main(argv=None):
    """Runs the check; returns the val sweep's results (one per checkpoint)."""

    args = parse_args(argv)
    from sparse_pooling_tpu_torch.data import synthetic
    from sparse_pooling_tpu_torch.runtime.evaluator import Evaluator
    from sparse_pooling_tpu_torch.runtime.trainer import Trainer

    workdir = args.workdir or tempfile.mkdtemp(prefix="spt_people_")
    root = f"{workdir}/kitti"
    n_total = args.train_frames + args.val_frames
    synthetic.write_kitti_tree(root, num_frames=n_total, n_ground=1024, n_obj=192,
                               val_frames=tuple(range(args.train_frames, n_total)), scene=args.scene)
    cfg = build_config(args, root, workdir)

    Trainer(cfg, device=args.device).train()
    eval_cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(cfg.dataset, split="val"))
    results = Evaluator(eval_cfg, device=args.device).repeated_checkpoint_run(max_wait=0)
    print("\nstep   class       AP_2d(mod)  AP_bev(mod)  AP_3d(mod)")
    for r in results:
        for cls in CLASSES:
            ap = r["ap"][cls]
            print(f"{r['step']:>5}  {cls:<10} {ap['2d']['moderate']:10.3f} {ap['bev']['moderate']:11.3f} "
                  f"{ap['3d']['moderate']:10.3f}")
    final = results[-1]["ap"]
    for cls in CLASSES:
        print(f"final {cls} BEV moderate AP on HELD-OUT val: {final[cls]['bev']['moderate']:.3f}")
    return results


if __name__ == "__main__":
    main()
