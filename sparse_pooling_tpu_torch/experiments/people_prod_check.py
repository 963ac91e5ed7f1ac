"""Production-lattice PEOPLE (Pedestrian + Cyclist) check on a HELD-OUT split.

    python -m sparse_pooling_tpu_torch.experiments.people_prod_check [--roi_quad 2] \
        [--steps 3000] [--seeds 0,7 | --seed N] [--device cuda]

Port of ``sparse_pooling_tpu.experiments.people_prod_check``. Where
``people_check.py`` trains at a reduced 0.4 m lattice, this check trains
the people preset at its production geometry (0.1 m voxels, 700x800 BEV,
384x1248 canvas, 0.3 m anchor stride, ~250k dense anchors capped at 16384)
on synthetic ``people_hard`` street scenes and evaluates held-out
per-class AP through ``Trainer`` -> checkpoints -> ``Evaluator`` -> KITTI
txt -> native AP, once per seed, with the mean and half-spread over the
seeds; the summary JSON goes to the workdir.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

CLASSES = ["Pedestrian", "Cyclist"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--train_frames", type=int, default=48)
    p.add_argument("--val_frames", type=int, default=48, help="held-out frames")
    p.add_argument("--seed", type=int, default=None, help="one seed (overrides --seeds)")
    p.add_argument("--seeds", default="0,7",
                   help="comma list of dataset seeds; mean +/- half-spread reported")
    p.add_argument("--flip_head", action="store_true",
                   help="enable avod.explicit_flip_head (explicit pi-disambiguation)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("--roi_quad", type=int, default=None,
                   help="override rpn.roi_quad (default: the preset's, 4)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=8e-4)
    p.add_argument("--dataset_root", default=None, help="reuse an existing tree")
    p.add_argument("--ap_points", type=int, default=40,
                   help="AP interpolation points (40 = the modern protocol)")
    p.add_argument("--scene", default="people_hard", choices=("people", "people_hard"),
                   help="people_hard (default) fills the moderate/hard bands with occluded and "
                   "truncated objects and clutter")
    return p.parse_args(argv)


def build_config(args, root: str, workdir: str):
    """-> (the check's pipeline config before the seed, its tag); sets
    ``args.roi_quad`` to the preset's where it was not given."""

    from sparse_pooling_tpu_torch.configs import people_pyramid_config
    from sparse_pooling_tpu_torch.configs.config import EvalConfig, OptimizerConfig

    base = people_pyramid_config()
    if args.roi_quad is None:
        args.roi_quad = base.model.rpn.roi_quad
    model = dataclasses.replace(base.model, rpn=dataclasses.replace(base.model.rpn, roi_quad=args.roi_quad))
    if args.flip_head:
        model = dataclasses.replace(model, avod=dataclasses.replace(model.avod, explicit_flip_head=True))
    tag = "_flip" if args.flip_head else ""
    cfg = dataclasses.replace(
        base,
        checkpoint_name=f"people_prod_q{args.roi_quad}{tag}",
        experiments_dir=f"{workdir}/exp",
        model=model,
        train=dataclasses.replace(
            base.train,
            batch_size=args.batch,
            max_iterations=args.steps,
            checkpoint_interval=max(args.steps // 2, 1),
            summary_interval=max(args.steps // 20, 1),
            optimizer=OptimizerConfig(initial_lr=args.lr, decay_steps=args.steps // 2, decay_rate=0.5),
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

    workdir = args.workdir or tempfile.mkdtemp(prefix="spt_people_prod_")
    root = args.dataset_root or f"{workdir}/kitti"
    n_total = args.train_frames + args.val_frames
    if not os.path.exists(os.path.join(root, "train.txt")):
        synthetic.write_kitti_tree(root, num_frames=n_total, n_ground=12288, n_obj=4096,
                                   val_frames=tuple(range(args.train_frames, n_total)), scene=args.scene)
    cfg, tag = build_config(args, root, workdir)
    seeds = cu.parse_seeds(args.seeds, args.seed)
    print(f"[people_prod] workdir {workdir} roi_quad={args.roi_quad} seeds={seeds}")
    per_seed = []
    for seed in seeds:
        cfg_s = cu.seed_config(cfg, seed)
        Trainer(cfg_s, device=args.device).train()
        ev = Evaluator(dataclasses.replace(cfg_s, dataset=dataclasses.replace(cfg_s.dataset, split="val")),
                       device=args.device)
        results = ev.repeated_checkpoint_run(max_wait=0)
        print(f"\n[seed {seed}; {args.ap_points}-pt protocol, scene={args.scene}] held-out val")
        print("step   class       metric     easy  moderate    hard")
        for r in results:
            for cls in CLASSES:
                ap = r["ap"][cls]
                for metric in ("2d", "bev", "3d", "aos"):
                    if metric in ap:
                        m = ap[metric]
                        print(f"{r['step']:>5}  {cls:<10} {metric:<6} {m['easy']:8.3f} "
                              f"{m['moderate']:8.3f} {m['hard']:8.3f}")
        best = cu.best_result(results, CLASSES)
        per_seed.append({
            "seed": seed,
            "final_ap": {c: results[-1]["ap"][c] for c in CLASSES},
            "best_step": best["step"],
            "best_ap": {c: best["ap"][c] for c in CLASSES},
            "eval_fps": results[-1]["frames_per_sec"],
        })

    agg_final = cu.aggregate_aps([s["final_ap"] for s in per_seed], CLASSES)
    agg_best = cu.aggregate_aps([s["best_ap"] for s in per_seed], CLASSES)
    if len(per_seed) > 1:
        cu.print_aggregate(agg_final, CLASSES, seeds, "final checkpoint")
        cu.print_aggregate(agg_best, CLASSES, seeds, "best checkpoint")
    summary = {
        "roi_quad": args.roi_quad,
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
        "eval_fps": per_seed[0]["eval_fps"],
    }
    out_path = os.path.join(workdir, f"people_prod_q{args.roi_quad}{tag}.json")
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"[people_prod] summary -> {out_path}")
    return summary


if __name__ == "__main__":
    main()
