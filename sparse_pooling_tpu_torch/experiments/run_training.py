"""Training CLI of the port.

    python -m sparse_pooling_tpu_torch.experiments.run_training --preset cars \
        --dataset_root <KITTI object tree> [--max_steps N] [--device cuda]

Port of ``sparse_pooling_tpu.experiments.run_training``: a JSON pipeline
config (``--pipeline_config``) or a preset, with the data split, dataset
root, experiments directory, step count and batch size overridable. Trains
on one card (``--device``, default ``cuda``; ``cpu`` runs the plain
PyTorch path). ``--multihost`` raises until ``parallel/`` is ported.
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
                   help="multi-host training; not ported (raises NotImplementedError)")
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


def main(argv=None):
    args = parse_args(argv)
    if args.multihost:
        raise NotImplementedError("--multihost: the port's parallel/ (torch.distributed) is not ported yet")
    cfg = load_config(args)
    from sparse_pooling_tpu_torch.runtime.trainer import Trainer

    trainer = Trainer(cfg, device=args.device)
    state = trainer.train(max_steps=args.max_steps)
    print(f"[run_training] finished at step {state.step}")
    return state


if __name__ == "__main__":
    main()
