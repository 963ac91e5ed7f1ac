"""Evaluation CLI of the port.

    python -m sparse_pooling_tpu_torch.experiments.run_evaluation --preset cars \
        --dataset_root <KITTI object tree> [--ckpt_step N] [--device cuda]

Port of ``sparse_pooling_tpu.experiments.run_evaluation``: evaluate one
checkpoint (``--ckpt_step``) or every checkpoint not yet evaluated, polling
for new ones for ``--watch_seconds``, writing KITTI-format predictions, the
AP of each step (``eval_<step>.json``) and its scalars. The configuration
comes as ``run_training`` reads it; the split defaults to ``val``. Runs on
one card (``--device``, default ``cuda``; ``cpu`` runs the plain PyTorch
path); with ``eval.data_parallel`` set and more than one card visible it
starts one rank per card (NCCL) and splits each val batch over them.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pipeline_config", default=None, help="JSON pipeline config path")
    p.add_argument("--preset", default="cars", choices=["cars", "rcnn_cars", "people", "unittest"])
    p.add_argument("--data_split", default="val")
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--experiments_dir", default=None)
    p.add_argument("--ckpt_step", type=int, default=None, help="evaluate this step only")
    p.add_argument("--watch_seconds", type=float, default=0.0,
                   help="keep polling for new checkpoints this long after the last one")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    return p.parse_args(argv)


def evaluate(cfg, device: str, ckpt_step, watch_seconds: float, verbose: bool = True):
    from sparse_pooling_tpu_torch.runtime.evaluator import Evaluator

    ev = Evaluator(cfg, device=device)
    if ckpt_step is not None:
        results = [ev.run_checkpoint_once(ckpt_step)]
    else:
        results = ev.repeated_checkpoint_run(max_wait=watch_seconds)
    results = [r for r in results if r is not None]
    if verbose:
        for r in results:
            print(json.dumps(r, indent=2 if ckpt_step is not None else None))
    return results


def _eval_rank(rank: int, cfg, ckpt_step, watch_seconds: float):
    return evaluate(cfg, "cuda", ckpt_step, watch_seconds, verbose=rank == 0)


def main(argv=None):
    args = parse_args(argv)
    from sparse_pooling_tpu_torch.experiments.run_training import load_config, per_card_ranks
    from sparse_pooling_tpu_torch.parallel import launch

    cfg = load_config(args)
    ranks = per_card_ranks(cfg.eval.data_parallel, args.device)
    if ranks:
        print(f"[run_evaluation] eval.data_parallel: one rank per card, {ranks} ranks (nccl)")
        return launch.spawn(_eval_rank, ranks, (cfg, args.ckpt_step, args.watch_seconds), backend="nccl",
                            device="cuda", timeout_s=7 * 24 * 3600.0)[0]
    return evaluate(cfg, args.device, args.ckpt_step, args.watch_seconds)


if __name__ == "__main__":
    main()
