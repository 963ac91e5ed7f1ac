"""Overfit learning check: end-to-end training evidence on 2 frames.

    python -m sparse_pooling_tpu_torch.experiments.overfit_check [--steps 2500] [--roi exact|fast] [--device cuda]

Port of ``sparse_pooling_tpu.experiments.overfit_check``. Trains the
unittest-scale detector (48x160 canvas: the tree's 375x1242 images go
through the host resize) on 2 synthetic frames and evaluates AP on the SAME
frames through the full path (``Trainer`` -> checkpoints -> ``Evaluator``
-> KITTI txt -> native AP). A healthy detector reaches 3D moderate Car AP
1.0 by ~2500 steps. ``--roi fast`` takes the strided RPN crops with a
channel projection instead of the exact ones.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=2500)
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument(
        "--roi", default="exact", choices=["exact", "fast"],
        help="'exact' = full-resolution RPN crops; 'fast' = the strided crops with a channel "
        "projection (bev/img_roi_stride 2, roi_channels 4)",
    )
    return p.parse_args(argv)


def build_config(args, root: str, workdir: str):
    """The check's pipeline config: the unittest preset with one car anchor
    size, a 1 m anchor stride, wider minibatch IoU bands, 2 frames a batch,
    checkpoints every fifth of the steps, no augmentation or shuffle."""

    from sparse_pooling_tpu_torch.configs import unittest_config
    from sparse_pooling_tpu_torch.configs.config import (
        AnchorConfig,
        EvalConfig,
        MiniBatchConfig,
        OptimizerConfig,
        TrainConfig,
    )
    from sparse_pooling_tpu_torch.configs.presets import CAR_SIZE

    cfg = unittest_config(dataset_root=root)
    rpn = cfg.model.rpn
    if args.roi == "fast":
        rpn = dataclasses.replace(rpn, bev_roi_stride=2, img_roi_stride=2, roi_channels=4)
    return dataclasses.replace(
        cfg,
        checkpoint_name="overfit_check",
        experiments_dir=f"{workdir}/exp",
        model=dataclasses.replace(
            cfg.model,
            rpn=rpn,
            anchors=AnchorConfig(sizes=(CAR_SIZE,), stride=1.0, max_anchors=1024),
            mini_batch=MiniBatchConfig(
                rpn_batch_size=128, avod_batch_size=32,
                rpn_pos_iou=(0.45, 1.0), avod_pos_iou=(0.55, 1.0),
            ),
        ),
        train=TrainConfig(
            batch_size=2, max_iterations=args.steps,
            checkpoint_interval=max(args.steps // 5, 1),
            summary_interval=max(args.steps // 10, 1),
            optimizer=OptimizerConfig(initial_lr=2e-3, decay_steps=args.steps // 2, decay_rate=0.5),
        ),
        eval=EvalConfig(kitti_score_threshold=0.05),
        dataset=dataclasses.replace(cfg.dataset, split="train", aug_flip=False, aug_pca_jitter=False,
                                    shuffle=False),
    )


def main(argv=None):
    """Runs the check; returns the sweep's results (one per checkpoint)."""

    args = parse_args(argv)
    from sparse_pooling_tpu_torch.data import synthetic
    from sparse_pooling_tpu_torch.runtime.evaluator import Evaluator
    from sparse_pooling_tpu_torch.runtime.trainer import Trainer

    workdir = args.workdir or tempfile.mkdtemp(prefix="spt_overfit_")
    root = f"{workdir}/kitti"
    synthetic.write_kitti_tree(root, num_frames=2, n_ground=1024, n_obj=256, val_frames=())
    cfg = build_config(args, root, workdir)

    Trainer(cfg, device=args.device).train()
    results = Evaluator(cfg, device=args.device).repeated_checkpoint_run(max_wait=0)
    print("\nstep  AP_2d(mod)  AP_bev(mod)  AP_3d(mod)")
    for r in results:
        ap = r["ap"]["Car"]
        print(f"{r['step']:>5} {ap['2d']['moderate']:10.3f} {ap['bev']['moderate']:11.3f} "
              f"{ap['3d']['moderate']:10.3f}")
    final = results[-1]["ap"]["Car"]["3d"]["moderate"]
    print(f"\nfinal 3D moderate AP: {final:.3f} (healthy: -> 1.0 by ~2500 steps)")
    return results


if __name__ == "__main__":
    main()
