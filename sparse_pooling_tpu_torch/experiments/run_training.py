"""Training CLI of the port.

    python -m sparse_pooling_tpu_torch.experiments.run_training --preset cars \
        --dataset_root <KITTI object tree> [--max_steps N] [--device cuda]
    torchrun --nproc_per_node 8 -m sparse_pooling_tpu_torch.experiments.run_training \
        --multihost --preset cars --dataset_root <tree>

Port of ``sparse_pooling_tpu.experiments.run_training``: a JSON pipeline
config (``--pipeline_config``) or a preset, with the data split, dataset
root, experiments directory, step count and batch size overridable.

``--multihost`` joins the process group that torchrun (or another launcher)
describes in the environment (``parallel.multihost.initialize``), prints
``process_info``, checks one all-reduce over the world and trains on the
mesh ``Trainer`` lays over it. Without it, with ``train.data_parallel`` set
and more than one card visible, the CLI starts one rank per card itself
(NCCL, rank = card); else it trains on one card (``--device``, default
``cuda``; ``cpu`` runs the plain PyTorch path).
"""

from __future__ import annotations

import argparse
import dataclasses


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pipeline_config", default=None, help="JSON pipeline config path")
    p.add_argument("--preset", default="cars", choices=["cars", "rcnn_cars", "people", "unittest"])
    p.add_argument("--data_split", default=None, help="train | val | trainval")
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--experiments_dir", default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group of MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK (torchrun's)")
    return p.parse_args(argv)


def load_config(args):
    """The pipeline config of the CLI's arguments (``--pipeline_config`` or
    ``--preset``, then the overrides given); shared with the evaluation and
    inference CLIs, which have no ``--batch_size``."""

    from sparse_pooling_tpu_torch.configs import pipeline_config_from_file
    from sparse_pooling_tpu_torch.configs.presets import preset

    cfg = pipeline_config_from_file(args.pipeline_config) if args.pipeline_config else preset(args.preset)
    ds = cfg.dataset
    if args.data_split:
        ds = dataclasses.replace(ds, split=args.data_split)
    if args.dataset_root:
        ds = dataclasses.replace(ds, root=args.dataset_root)
    cfg = dataclasses.replace(cfg, dataset=ds)
    if args.experiments_dir:
        cfg = dataclasses.replace(cfg, experiments_dir=args.experiments_dir)
    if getattr(args, "batch_size", None):
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=args.batch_size))
    return cfg


def per_card_ranks(enabled: bool, device: str) -> int:
    """The ranks the CLI starts itself: one per visible card when the
    config's data parallelism is on and ``device`` names no single card."""

    import torch

    n = torch.cuda.device_count()
    return n if enabled and device == "cuda" and n > 1 else 0


def _train_rank(rank: int, cfg, max_steps):
    from sparse_pooling_tpu_torch.runtime.trainer import Trainer

    state = Trainer(cfg, device="cuda").train(max_steps=max_steps)
    return None if state is None else state.step


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args)
    from sparse_pooling_tpu_torch.parallel import launch, multihost
    from sparse_pooling_tpu_torch.runtime.trainer import Trainer

    ranks = per_card_ranks(cfg.train.data_parallel, args.device)
    if ranks and not args.multihost:
        print(f"[run_training] train.data_parallel: one rank per card, {ranks} ranks (nccl)")
        steps = launch.spawn(_train_rank, ranks, (cfg, args.max_steps), backend="nccl", device="cuda",
                             timeout_s=7 * 24 * 3600.0)
        print(f"[run_training] finished at step {steps[0]}")
        return steps[0]
    if args.multihost:
        multihost.initialize(device=args.device)
        print(f"[run_training] {multihost.process_info()}; all_reduce of ones = "
              f"{multihost.check_collective():g}", flush=True)
    try:
        state = Trainer(cfg, device=args.device).train(max_steps=args.max_steps)
    finally:
        if args.multihost:
            multihost.shutdown()
    if state is not None:
        print(f"[run_training] finished at step {state.step}")
    return state


if __name__ == "__main__":
    main()
