"""Production-lattice cars learning check on a HELD-OUT val split.

    python -m sparse_pooling_tpu_torch.experiments.cars_check [--preset cars|rcnn_cars] \
        [--seeds 0,7 | --seed N] [--dataset_root <tree>] [--device cuda]

Port of ``sparse_pooling_tpu.experiments.cars_check``. Trains the cars
preset (or ``--preset rcnn_cars``) at its production geometry (0.1 m
voxels, 700x800 BEV, 384x1248 canvas, 16384-anchor cap) on synthetic
``cars_hard`` scenes (occluded and truncated objects in every difficulty
band; ``--scene cars`` for the plain ones) and evaluates held-out AP
through ``Trainer`` -> checkpoints -> ``Evaluator`` -> KITTI txt -> native
AP, once per seed on the same tree, with the mean and half-spread over the
seeds. The last checkpoint's predictions then go through a heading-flip
audit: every predicted heading turned by pi, 2D/BEV/3D AP must hold and AOS
collapse. ``--roi_quad``, ``--s2_bev_stride``/``--s2_img_stride`` and the
other overrides A/B one option at a time; the summary JSON goes to the
workdir.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile


def _heading_flip_audit(ev, final_result, ap_points):
    """Show that the AOS metric bites on this trained model's outputs.

    Flips every predicted heading by pi (ry + pi, alpha + pi) in a copy of
    the final checkpoint's prediction dir and scores it again: 2D/BEV/3D AP
    must hold (a box's footprint is pi-symmetric) while AOS collapses. A
    detector whose orientation head were at chance would score like the
    flipped copy."""

    import math
    import shutil

    from sparse_pooling_tpu_torch.data.labels import read_labels, write_labels
    from sparse_pooling_tpu_torch.native import kitti_eval

    step = final_result["step"]
    thresh = ev.cfg.eval.kitti_score_threshold
    pred_dir = os.path.join(ev.workdir, "predictions", "kitti_native_eval", f"{thresh:g}", str(step), "data")
    flip_dir = pred_dir.rstrip("/") + "_heading_flipped"
    shutil.rmtree(flip_dir, ignore_errors=True)
    os.makedirs(flip_dir)
    for fname in os.listdir(pred_dir):
        if not fname.endswith(".txt"):
            continue
        labels = read_labels(os.path.join(pred_dir, fname))
        for lb in labels:
            lb.ry = math.remainder(lb.ry + math.pi, 2 * math.pi)
            lb.alpha = math.remainder(lb.alpha + math.pi, 2 * math.pi)
        write_labels(os.path.join(flip_dir, fname), labels)
    gt_dir = os.path.join(ev.dataset.base, "label_2")
    classes = list(ev.cfg.model.classes)
    flipped = kitti_eval.evaluate_dirs(gt_dir, flip_dir, classes, n_points=ap_points)
    base = final_result["ap"]
    print("\n[heading-flip audit] pi-flipped predictions, moderate band:")
    for cls in classes:
        b, f = base[cls], flipped[cls]
        print(f"  {cls}: 3d {b['3d']['moderate']:.3f} -> {f['3d']['moderate']:.3f} (must hold)   "
              f"aos {b['aos']['moderate']:.3f} -> {f['aos']['moderate']:.3f} (must collapse)")
    return {cls: {"base": base[cls], "flipped": flipped[cls]} for cls in classes}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--preset", default="cars", choices=("cars", "rcnn_cars"),
                   help="detector family: 'cars' = the AVOD-style SHPL detector, 'rcnn_cars' = the "
                   "MV3D-style FusionRcnn at the same production geometry")
    p.add_argument("--train_frames", type=int, default=48)
    p.add_argument("--val_frames", type=int, default=48,
                   help="held-out frames (16-frame single-seed deltas under ~0.06 AP are run noise)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("--roi_quad", type=int, default=4)
    p.add_argument("--s2_bev_stride", type=int, default=None, help="override avod.bev_roi_stride")
    p.add_argument("--s2_img_stride", type=int, default=None, help="override avod.img_roi_stride")
    p.add_argument("--max_anchors", type=int, default=None)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=8e-4)
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="optimizer grad_clip_norm (0 = off); the rcnn box_4c arm needs it")
    p.add_argument("--checkpoint_interval", type=int, default=None,
                   help="checkpoint and sweep spacing (default steps // 2)")
    p.add_argument("--dataset_root", default=None, help="reuse an existing tree")
    p.add_argument("--ap_points", type=int, default=40,
                   help="AP interpolation points (40 = the modern KITTI protocol; 11 = classic)")
    p.add_argument("--scene", default="cars_hard", choices=("cars", "cars_hard"),
                   help="cars_hard (default) fills the moderate/hard bands with occluded and "
                   "truncated objects, 15-25 a frame")
    p.add_argument("--no_heading_audit", action="store_true", help="skip the heading-flip AOS audit")
    p.add_argument("--ang_weight", type=float, default=None, help="override avod.loss_ang_weight")
    p.add_argument("--seed", type=int, default=None, help="one seed (overrides --seeds)")
    p.add_argument("--seeds", default="0,7",
                   help="comma list of dataset shuffle/augment seeds; one training each on the same "
                   "tree, mean +/- half-spread reported")
    p.add_argument("--eval_nms_size", type=int, default=None, help="override rpn.eval_nms_size")
    p.add_argument("--pre_top_k", type=int, default=None, help="override rpn.pre_nms_top_k")
    p.add_argument("--pool_channels", type=int, default=None, help="override sparse_pool.pool_channels")
    p.add_argument("--rcnn_box_rep", default=None, choices=("offsets", "box_4c", "box_8c"),
                   help="override avod.box_rep (the rcnn_cars preset's stage-2 regression)")
    p.add_argument("--flip_head", action="store_true",
                   help="enable avod.explicit_flip_head: a binary pi-disambiguation logit on stage 2")
    return p.parse_args(argv)


def build_config(args, root: str, workdir: str):
    """-> (the check's pipeline config before the seed, the overrides' tag)."""

    from sparse_pooling_tpu_torch.configs.config import EvalConfig, OptimizerConfig
    from sparse_pooling_tpu_torch.configs.presets import preset as preset_fn

    base = preset_fn(args.preset)
    model = dataclasses.replace(base.model, rpn=dataclasses.replace(base.model.rpn, roi_quad=args.roi_quad))

    def section(name: str, **fields):
        return dataclasses.replace(model, **{name: dataclasses.replace(getattr(model, name), **fields)})

    if args.max_anchors:
        model = section("anchors", max_anchors=args.max_anchors)
    if args.ang_weight is not None:
        model = section("avod", loss_ang_weight=args.ang_weight)
    if args.flip_head:
        model = section("avod", explicit_flip_head=True)
    if args.rcnn_box_rep is not None:
        model = section("avod", box_rep=args.rcnn_box_rep)
    if args.eval_nms_size is not None:
        model = section("rpn", eval_nms_size=args.eval_nms_size)
    if args.pre_top_k is not None:
        model = section("rpn", pre_nms_top_k=args.pre_top_k)
    if args.pool_channels is not None:
        model = section("sparse_pool", pool_channels=args.pool_channels)
    tag = "" if args.ang_weight is None else f"_ang{args.ang_weight:g}"
    if args.flip_head:
        tag += "_flip"
    if args.rcnn_box_rep is not None:
        tag += f"_{args.rcnn_box_rep}"
    if args.eval_nms_size is not None:
        tag += f"_nms{args.eval_nms_size}"
    if args.pre_top_k is not None:
        tag += f"_ptk{args.pre_top_k}"
    if args.pool_channels is not None:
        tag += f"_pc{args.pool_channels}"
    if args.s2_bev_stride is not None:
        model = section("avod", bev_roi_stride=args.s2_bev_stride)
    if args.s2_img_stride is not None:
        model = section("avod", img_roi_stride=args.s2_img_stride)
    if args.s2_bev_stride is not None or args.s2_img_stride is not None:
        tag += f"_s2b{model.avod.bev_roi_stride}i{model.avod.img_roi_stride}"
    cfg = dataclasses.replace(
        base,
        checkpoint_name=f"{args.preset}_check_q{args.roi_quad}" + tag
        + (f"_a{args.max_anchors}" if args.max_anchors else ""),
        experiments_dir=f"{workdir}/exp",
        model=model,
        train=dataclasses.replace(
            base.train,
            batch_size=args.batch,
            max_iterations=args.steps,
            checkpoint_interval=args.checkpoint_interval or max(args.steps // 2, 1),
            summary_interval=max(args.steps // 20, 1),
            optimizer=OptimizerConfig(initial_lr=args.lr, decay_steps=args.steps // 2, decay_rate=0.5,
                                      grad_clip_norm=args.grad_clip),
        ),
        eval=EvalConfig(kitti_score_threshold=0.05, batch_size=4, ap_n_points=args.ap_points),
        dataset=dataclasses.replace(base.dataset, root=root, split="train", aug_flip=True,
                                    aug_pca_jitter=False, shuffle=True),
    )
    return cfg, tag


def main(argv=None):
    """Runs the check; returns its summary (also written as JSON)."""

    args = parse_args(argv)
    from sparse_pooling_tpu_torch.data import synthetic
    from sparse_pooling_tpu_torch.experiments import check_utils as cu
    from sparse_pooling_tpu_torch.runtime.evaluator import Evaluator
    from sparse_pooling_tpu_torch.runtime.trainer import Trainer

    workdir = args.workdir or tempfile.mkdtemp(prefix="spt_cars_check_")
    root = args.dataset_root or f"{workdir}/kitti"
    n_total = args.train_frames + args.val_frames
    if not os.path.exists(os.path.join(root, "train.txt")):
        synthetic.write_kitti_tree(root, num_frames=n_total, n_ground=12288, n_obj=4096,
                                   val_frames=tuple(range(args.train_frames, n_total)), scene=args.scene)
    cfg, tag = build_config(args, root, workdir)
    seeds = cu.parse_seeds(args.seeds, args.seed)
    print(f"[cars_check] workdir {workdir} preset={args.preset} roi_quad={args.roi_quad} seeds={seeds}")

    per_seed = []
    for seed in seeds:
        cfg_s = cu.seed_config(cfg, seed)
        Trainer(cfg_s, device=args.device).train()
        ev = Evaluator(dataclasses.replace(cfg_s, dataset=dataclasses.replace(cfg_s.dataset, split="val")),
                       device=args.device)
        results = ev.repeated_checkpoint_run(max_wait=0)
        print(f"\n[seed {seed}; {args.ap_points}-pt protocol, scene={args.scene}] Car, held-out val — "
              "easy/moderate/hard")
        print("step   metric      easy   moderate   hard")
        for r in results:
            ap = r["ap"]["Car"]
            for metric in ("2d", "bev", "3d", "aos"):
                if metric in ap:
                    m = ap[metric]
                    print(f"{r['step']:>5}  {metric:<6} {m['easy']:8.3f} {m['moderate']:8.3f} {m['hard']:8.3f}")
        heading_audit = None
        if not args.no_heading_audit and results:
            heading_audit = _heading_flip_audit(ev, results[-1], args.ap_points)
        best = cu.best_result(results, ["Car"])
        per_seed.append({
            "seed": seed,
            "final_ap": results[-1]["ap"]["Car"],
            "best_step": best["step"],
            "best_ap": best["ap"]["Car"],
            "heading_flip_audit": heading_audit,
            "eval_fps": results[-1]["frames_per_sec"],
        })

    agg_final = cu.aggregate_aps([{"Car": s["final_ap"]} for s in per_seed], ["Car"])
    agg_best = cu.aggregate_aps([{"Car": s["best_ap"]} for s in per_seed], ["Car"])
    if len(per_seed) > 1:
        cu.print_aggregate(agg_final, ["Car"], seeds, "final checkpoint")
        cu.print_aggregate(agg_best, ["Car"], seeds, "best checkpoint")
    summary = {
        "preset": args.preset,
        "roi_quad": args.roi_quad,
        "max_anchors": args.max_anchors,
        "steps": args.steps,
        "ap_points": args.ap_points,
        "scene": args.scene,
        "flip_head": args.flip_head,
        "seeds": seeds,
        "val_frames": args.val_frames,
        "device": args.device,
        "per_seed": per_seed,
        "aggregate_final": agg_final,
        "aggregate_best": agg_best,
        "final_ap": per_seed[0]["final_ap"],
        "heading_flip_audit": per_seed[0]["heading_flip_audit"],
        "eval_fps": per_seed[0]["eval_fps"],
    }
    out_path = os.path.join(workdir, f"{args.preset}_check_q{args.roi_quad}{tag}.json")
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"[cars_check] summary -> {out_path}")
    return summary


if __name__ == "__main__":
    main()
