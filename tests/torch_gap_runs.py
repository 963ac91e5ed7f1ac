"""Paired learning runs behind the 3D-gap decomposition (not a test module).

Two subcommands, run from the repo root:

``card`` trains one ``cars_check`` arm of the port (any of its arguments
after ``--``) with the port's ``Trainer(seed=--init_seed)``, stops at
``--stop_step`` of the ``--steps`` schedule (the rate decays at half the
schedule, as it would in the full run), and runs
``experiments.analyze_2d_gap`` over each checkpoint's predictions. It
imports only the port (the card machine has no flax), and writes one JSON:
the arm, each checkpoint's moderate AP, the decomposition's summary::

    python3 tests/torch_gap_runs.py card --init_seed 1 --stop_step 4000 --json out.json -- \\
        --preset rcnn_cars --rcnn_box_rep box_4c --flip_head --steps 8000 \\
        --checkpoint_interval 2000 --seed 0 --dataset_root build/cars_hard --workdir build/r1

``cpu`` trains the ``unittest`` lattice's arms on the CPU with either
package over one tree, through each package's ``rcnn_2d_gap_check`` (the
JAX tool from ``tools/``, unchanged; the port's ``experiments``), at each
init seed: ``init_state(seed=s)`` in JAX, ``Trainer(seed=s)`` in the port.
An arm is ``ARCH[:BOX_REP[:BEV_ROI_STRIDE]]``; the tree is written once by
the first side to run and reused by the other::

    python tests/torch_gap_runs.py cpu --side jax --arms avod,avod:box_4c:4 \\
        --seeds 0,1,2 --steps 2000 --workdir build/pair --json jax.json

``table`` prints the mean ± half-spread of each (side, arm) over the runs
of ``cpu`` reports, or over ``card`` reports of one arm at any dataset and
init seeds (at their last checkpoint or ``--step``): moderate AP and the
decomposition's medians::

    python tests/torch_gap_runs.py table jax.json torch.json
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

METRICS = ("2d", "bev", "3d", "aos")


def _moderate(ap_cls):
    return {m: ap_cls[m]["moderate"] for m in METRICS if m in ap_cls}


def _vertical(gt_dir, pred_dir, min_score=0.1):
    """Beyond the tool's ``3d|gt_hy`` (which equals ``bev`` by construction:
    with GT's y and h the vertical overlap is whole): the 3D IoU with GT's y
    alone and h alone, and the signed errors of y and h, over the same
    matched detections -> {key: median}."""

    import numpy as np

    from sparse_pooling_tpu_torch.data.labels import read_labels
    from sparse_pooling_tpu_torch.experiments.analyze_2d_gap import _box7
    from sparse_pooling_tpu_torch.runtime import metrics as M

    rec = {"3d|gt_y": [], "3d|gt_h": [], "dy": [], "dh": []}
    for fname in sorted(os.listdir(pred_dir)):
        if not fname.endswith(".txt"):
            continue
        gts = [_box7(g) for g in read_labels(os.path.join(gt_dir, fname)) if g.type == "Car"]
        for d in read_labels(os.path.join(pred_dir, fname)):
            if d.type != "Car" or d.score < min_score or not gts:
                continue
            db = _box7(d)
            ovs = [M.bev_iou(db[[0, 2, 3, 4, 6]], g[[0, 2, 3, 4, 6]]) for g in gts]
            if max(ovs) < 0.1:
                continue
            gb = gts[int(np.argmax(ovs))]
            for key, i in (("3d|gt_y", 1), ("3d|gt_h", 5)):
                cb = db.copy()
                cb[i] = gb[i]
                rec[key].append(M.iou_3d(cb, gb))
            rec["dy"].append(db[1] - gb[1])
            rec["dh"].append(db[5] - gb[5])
    return {k: float(np.median(v)) for k, v in rec.items() if v}


def _decompose(gt_dir, pred_dir):
    from sparse_pooling_tpu_torch.experiments import analyze_2d_gap as gap

    rows = gap.analyze(gt_dir, pred_dir, gap.calib_dir_of(gt_dir), "Car", 0.1, (375, 1242))
    if not rows:
        return {"matched": 0}
    return {"matched": len(rows), "summary": gap.summarize(rows), "vertical": _vertical(gt_dir, pred_dir)}


def card(args, rest):
    from sparse_pooling_tpu_torch.experiments import cars_check
    from sparse_pooling_tpu_torch.runtime import evaluator as ev_mod
    from sparse_pooling_tpu_torch.runtime import trainer as tr_mod

    results = []

    class SeededTrainer(tr_mod.Trainer):
        def __init__(self, *a, **kw):
            kw["seed"] = args.init_seed
            super().__init__(*a, **kw)

        def train(self, max_steps=None):
            return super().train(min(max_steps or self.cfg.train.max_iterations, args.stop_step))

    class RecordingEvaluator(ev_mod.Evaluator):
        def repeated_checkpoint_run(self, *a, **kw):
            out = super().repeated_checkpoint_run(*a, **kw)
            results.extend(out)
            return out

    cc = cars_check.parse_args(rest)
    if not (cc.dataset_root and cc.workdir):
        raise SystemExit("card needs cars_check's --dataset_root and --workdir")
    tr_mod.Trainer, ev_mod.Evaluator = SeededTrainer, RecordingEvaluator
    summary = cars_check.main(rest)
    gt_dir = os.path.join(cc.dataset_root, "training", "label_2")
    report = {"argv": rest, "init_seed": args.init_seed, "stop_step": args.stop_step, "steps": {}}
    for r in results:
        pred = glob.glob(os.path.join(cc.workdir, "exp", "*", "predictions", "kitti_native_eval", "*",
                                      str(r["step"]), "data"))
        if len(pred) != 1:
            raise RuntimeError(f"step {r['step']}: expected one prediction dir, found {pred}")
        report["steps"][r["step"]] = {"ap": _moderate(r["ap"]["Car"]), "gap": _decompose(gt_dir, pred[0]),
                                      "pred_dir": pred[0]}
    report["heading_flip_audit"] = summary["heading_flip_audit"]
    with open(args.json, "w") as f:
        json.dump(report, f, indent=1)
    for step, s in report["steps"].items():
        g = s["gap"].get("summary", {})
        print(f"[gap] step {step} AP " + " ".join(f"{k}={v:.3f}" for k, v in s["ap"].items())
              + f" matched={s['gap']['matched']} medians "
              + " ".join(f"{k}={g[k]['median']:.3f}" for k in ("bev", "iou3d", "3d|gt_hy") if k in g)
              + " " + " ".join(f"{k}={v:.3f}" for k, v in s["gap"].get("vertical", {}).items()))


def cpu(args, _rest):
    arms, seeds = args.arms.split(","), [int(s) for s in args.seeds.split(",")]
    root = _tree(args)
    report = {"side": args.side, "steps": args.steps, "runs": []}
    for seed in seeds:
        for arm in arms:
            workdir = os.path.join(args.workdir, f"{args.side}_{arm.replace(':', '_')}_i{seed}")
            res = (_jax_arm if args.side == "jax" else _torch_arm)(root, workdir, args.steps, arm, seed)
            run = {"arm": arm, "init_seed": seed, "ap": _moderate(res["ap"]["Car"]),
                   "gap": _decompose(os.path.join(root, "training", "label_2"), res["pred_dir"])}
            report["runs"].append(run)
            g = run["gap"].get("summary", {})
            print(f"[pair] {args.side} {arm} init {seed}: "
                  + " ".join(f"{k}={v:.3f}" for k, v in run["ap"].items()) + " medians "
                  + " ".join(f"{k}={g[k]['median']:.3f}" for k in ("bev", "iou3d", "3d|gt_hy") if k in g)
                  + " " + " ".join(f"{k}={v:.3f}" for k, v in run["gap"].get("vertical", {}).items()),
                  flush=True)
            with open(args.json, "w") as f:
                json.dump(report, f, indent=1)


def _tree(args):
    """The tree both sides share, as both tools write it (the port's writer:
    text, .bin and decoded PNGs equal to the JAX writer's)."""

    from sparse_pooling_tpu_torch.data import synthetic

    root = os.path.join(args.workdir, "kitti")
    n = args.train_frames + args.val_frames
    if not os.path.exists(os.path.join(root, "train.txt")):
        synthetic.write_kitti_tree(root, num_frames=n, n_ground=2048, n_obj=512,
                                   val_frames=tuple(range(args.train_frames, n)), scene=args.scene)
    return root


def _torch_arm(root, workdir, steps, arm, seed):
    from sparse_pooling_tpu_torch.experiments import rcnn_2d_gap_check as tool

    return tool.train_and_evaluate(tool.arm_config(root, workdir, steps, arm), "cpu", seed=seed)


def _jax_arm(root, workdir, steps, arm, seed):
    """``tools/rcnn_2d_gap_check.py``'s training and evaluation of one arm
    (its config, which the port's ``arm_config`` copies), from
    ``init_state(seed=seed)``."""

    import functools

    import jax

    jax.config.update("jax_platforms", "cpu")
    from sparse_pooling_tpu.configs.config import pipeline_config_from_dict
    from sparse_pooling_tpu.runtime.evaluator import Evaluator
    from sparse_pooling_tpu.runtime.trainer import Trainer
    from sparse_pooling_tpu_torch.experiments.rcnn_2d_gap_check import arm_config

    cfg = pipeline_config_from_dict(dataclasses.asdict(arm_config(root, workdir, steps, arm)))
    trainer = Trainer(cfg)
    trainer.init_state = functools.partial(trainer.init_state, seed=seed)
    trainer.train()
    ev = Evaluator(dataclasses.replace(cfg, dataset=dataclasses.replace(cfg.dataset, split="val")))
    results = ev.repeated_checkpoint_run(max_wait=0)
    thresh = cfg.eval.kitti_score_threshold
    return {"ap": results[-1]["ap"], "step": results[-1]["step"],
            "pred_dir": os.path.join(ev.workdir, "predictions", "kitti_native_eval", f"{thresh:g}",
                                     str(results[-1]["step"]), "data")}


def _spread(values):
    """mean ± half-spread (half of max - min), the learning checks' rule."""

    return f"{sum(values) / len(values):.3f} ± {(max(values) - min(values)) / 2:.3f}"


def table(args, _rest):
    """Mean ± half-spread over the runs of each (side, arm) in ``cpu``
    reports, or over the ``card`` reports given, at each key."""

    groups = {}
    for path in args.reports:
        with open(path) as f:
            rep = json.load(f)
        if "runs" in rep:  # a cpu report
            for run in rep["runs"]:
                groups.setdefault((rep["side"], run["arm"]), []).append({**run, "pair": run["init_seed"]})
        else:  # a card report at its last step (or --step), paired by (dataset, init) seed
            step = str(args.step) if args.step else max(rep["steps"], key=int)
            argv, drop = rep["argv"], ("--seed", "--workdir", "--dataset_root")
            arm = " ".join(a for i, a in enumerate(argv) if a not in drop and (i == 0 or argv[i - 1] not in drop))
            seed = argv[argv.index("--seed") + 1] if "--seed" in argv else "0"
            groups.setdefault((f"card step {step}", arm), []).append(
                {**rep["steps"][step], "pair": (seed, rep["init_seed"])})
    for (side, arm), runs in sorted(groups.items()):
        row = {f"AP {m}": [r["ap"][m] for r in runs] for m in METRICS}
        with_rows = [r for r in runs if r["gap"]["matched"]]
        for k in ("bev", "iou3d", "3d|gt_hy"):
            row[f"med {k}"] = [r["gap"]["summary"][k]["median"] for r in with_rows]
        row["med bev-iou3d"] = [r["gap"]["summary"]["bev"]["median"] - r["gap"]["summary"]["iou3d"]["median"]
                                for r in with_rows]
        for k in ("3d|gt_y", "3d|gt_h", "dy", "dh"):
            row[f"med {k}"] = [r["gap"]["vertical"][k] for r in with_rows]
        row["matched"] = [r["gap"]["matched"] for r in runs]
        print(f"{side} {arm} (n={len(runs)}): " + "; ".join(
            f"{k} {_spread(v)}" for k, v in row.items() if v))
    if args.delta:  # paired by init seed within each side
        a, b = args.delta.split(",")
        for side in sorted({sd for sd, _ in groups}):
            runs = {arm: {r["pair"]: r for r in rs} for (sd, arm), rs in groups.items() if sd == side}
            if a not in runs or b not in runs:
                continue
            seeds = sorted(set(runs[a]) & set(runs[b]))
            pairs = [(runs[a][i], runs[b][i]) for i in seeds]
            out = {f"AP {m}": [rb["ap"][m] - ra["ap"][m] for ra, rb in pairs] for m in METRICS}
            for k in ("bev", "iou3d"):
                med = lambda r: r["gap"]["summary"][k]["median"]  # noqa: E731
                out[f"med {k}"] = [med(rb) - med(ra) for ra, rb in pairs]
            print(f"{side} {b} minus {a}, paired by seed {seeds}: " + "; ".join(
                f"{k} {_spread(v)}" for k, v in out.items()))


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("card")
    c.add_argument("--init_seed", type=int, default=0)
    c.add_argument("--stop_step", type=int, required=True)
    c.add_argument("--json", required=True)
    q = sub.add_parser("cpu")
    q.add_argument("--side", choices=("jax", "torch"), required=True)
    q.add_argument("--arms", default="avod,rcnn")
    q.add_argument("--seeds", default="0,1,2")
    q.add_argument("--steps", type=int, default=2000)
    q.add_argument("--train_frames", type=int, default=24)
    q.add_argument("--val_frames", type=int, default=8)
    q.add_argument("--scene", default="cars")
    q.add_argument("--workdir", required=True)
    q.add_argument("--json", required=True)
    t = sub.add_parser("table")
    t.add_argument("reports", nargs="+")
    t.add_argument("--step", type=int, default=None, help="a card report's checkpoint (default its last)")
    t.add_argument("--delta", default=None,
                   help="ARM_A,ARM_B: B minus A, paired by init seed (cpu) or dataset and init seed (card)")
    argv = sys.argv[1:]
    rest = argv[argv.index("--") + 1:] if "--" in argv else []
    args = p.parse_args(argv[: argv.index("--")] if "--" in argv else argv)
    {"card": card, "cpu": cpu, "table": table}[args.cmd](args, rest)


if __name__ == "__main__":
    main()
