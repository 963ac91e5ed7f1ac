"""Inference CLI of the port: per-frame detections as KITTI txt.

    python -m sparse_pooling_tpu_torch.experiments.run_inference --preset cars \
        --dataset_root <KITTI object tree> [--ckpt_step N] [--out_dir DIR] \
        [--save_npy] [--profile_dir DIR] [--device cuda]

Port of ``sparse_pooling_tpu.experiments.run_inference``: restore a
checkpoint (``--ckpt_step``, else the latest; with none, seeded random
weights from ``weights.init_like_flax``, and it says so), run each frame of
the split (default ``val``) as a batch of one through ``forward_batch_fn`` +
``decode_batch``, and write its detections above ``eval.score_threshold``
with ``runtime.predictions.write_predictions`` into ``--out_dir`` (default
``<workdir>/inference/<step>``); ``--save_npy`` also saves each frame's
boxes [C, K, 7], ``--profile_dir`` writes a ``torch.profiler`` Chrome trace
of the run. Runs on one card (``--device``, default ``cuda``; ``cpu`` runs
the plain PyTorch path).
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pipeline_config", default=None, help="JSON pipeline config path")
    p.add_argument("--preset", default="cars", choices=["cars", "rcnn_cars", "people", "unittest"])
    p.add_argument("--data_split", default="val")
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--experiments_dir", default=None)
    p.add_argument("--ckpt_step", type=int, default=None, help="default: the latest checkpoint")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--save_npy", action="store_true")
    p.add_argument("--profile_dir", default=None, help="write a torch.profiler trace of the run here")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    from sparse_pooling_tpu_torch import resolve_device, weights
    from sparse_pooling_tpu_torch.configs.config import AreaExtents
    from sparse_pooling_tpu_torch.data.dataset import KittiDataset
    from sparse_pooling_tpu_torch.experiments.run_training import load_config
    from sparse_pooling_tpu_torch.models import pipeline as pl
    from sparse_pooling_tpu_torch.runtime import checkpoint as ckpt_mod
    from sparse_pooling_tpu_torch.runtime import predictions as pred_mod
    from sparse_pooling_tpu_torch.runtime.evaluator import raw_p2
    from sparse_pooling_tpu_torch.runtime.profiling import trace

    cfg = load_config(args)
    dev = resolve_device(args.device)
    ext = AreaExtents()
    ds = KittiDataset(cfg.dataset, cfg.model, ext)
    model = pl.make_model(cfg.model, ext, device=dev)
    anchors = pl.static_anchor_grid(cfg.model, ext, device=dev)
    workdir = os.path.join(cfg.experiments_dir, cfg.checkpoint_name)
    ckpt_dir = os.path.join(workdir, "checkpoints")
    step = args.ckpt_step if args.ckpt_step is not None else ckpt_mod.latest_step(ckpt_dir)
    if step is None:
        weights.init_like_flax(model, seed=0)
        print("[run_inference] no checkpoint found; using seeded random weights (init_like_flax, seed 0)")
    else:
        model.load_state_dict(ckpt_mod.restore(ckpt_dir, step, map_location="cpu")["model"])
        print(f"[run_inference] restored step {step}")

    out_dir = args.out_dir or os.path.join(workdir, "inference", str(step or 0))
    os.makedirs(out_dir, exist_ok=True)
    canvas_hw = (cfg.model.image.height, cfg.model.image.width)
    profile = trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    with profile, torch.inference_mode():
        for sid in ds.sample_ids:
            sample = ds.load_sample(sid)
            arrays = ds.stack_samples([sample])
            batch = pl.RawSample(*(None if a is None else torch.from_numpy(a).to(dev) for a in arrays))
            out = pl.forward_batch_fn(model, batch, anchors, cfg.model, ext)
            det = {k: v[0].float().cpu().numpy() if v.is_floating_point() else v[0].cpu().numpy()
                   for k, v in pl.decode_batch(out, batch.ground_plane, cfg.model, ext).items()}
            pred_mod.write_predictions(out_dir, sid, det, cfg.model.classes, raw_p2(sample, canvas_hw),
                                       sample.raw_image_hw, score_threshold=cfg.eval.score_threshold)
            if args.save_npy:
                np.save(os.path.join(out_dir, sid + ".npy"), det["boxes_3d"])
            print(f"[run_inference] {sid}: {int(det['valid'].sum())} detections")
    print(f"[run_inference] wrote predictions to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
