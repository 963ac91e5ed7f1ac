"""The multi-rank dry run on the CPU: the production ``Trainer`` on a
``(data, model)`` mesh against one process.

The port's counterpart of the JAX package's ``dryrun_multichip``.
``dryrun_multichip(n)`` starts ``n`` CPU ranks over gloo (data ``n / 2`` x
model 2), trains ``Trainer`` for a few steps on a synthetic KITTI tree with
the ``unittest`` preset, and holds the sharded run's losses against one
process's over the same tree and seed at rtol 1e-5. The tree's 375x1242
images reach the ``unittest`` preset's 48x160 canvas through the host
resize (``data/pil_resize.py``), as in the JAX package's dry run.

    python -m sparse_pooling_tpu_torch.parallel.dryrun [N]
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import tempfile
from typing import Dict

import numpy as np

LOSS_RTOL = 1e-5


def dryrun_config(root: str, experiments_dir: str, n_data: int, n_model: int):
    """The ``unittest`` preset over the tree at ``root``: global batch
    ``n_data`` (one frame a data rank), ``model_parallel`` ``n_model``, a
    summary and a checkpoint every step."""

    from sparse_pooling_tpu_torch.configs import unittest_config

    cfg = unittest_config(dataset_root=root)
    return dataclasses.replace(
        cfg, experiments_dir=experiments_dir,
        train=dataclasses.replace(cfg.train, batch_size=n_data, model_parallel=n_model, data_parallel=True,
                                  summary_interval=1, checkpoint_interval=1),
    )


def train_rank(rank: int, cfg, steps: int) -> Dict:
    """One rank of the mesh run: ``Trainer(cfg).train(steps)`` on the CPU;
    returns its mesh's shape and its stage-2 fc1 shard's shape."""

    del rank
    from sparse_pooling_tpu_torch.runtime.trainer import Trainer

    trainer = Trainer(cfg, device="cpu")
    state = trainer.train(max_steps=steps)
    if trainer.mesh is None or state is None:
        raise RuntimeError("the dry run's rank built no mesh")
    return {"mesh": trainer.mesh.shape, "fc1": tuple(trainer.model.stage2_head.fc1.weight.shape)}


def losses_of(workdir: str):
    from sparse_pooling_tpu_torch.runtime.summary import read_scalars

    return [r["total"] for r in read_scalars(os.path.join(workdir, "summaries"))]


def dryrun_multichip(n_devices: int = 4, steps: int = 2, timeout_s: float = 600.0) -> Dict:
    """Train the production ``Trainer`` for ``steps`` steps on ``n_devices``
    CPU ranks (data ``n_devices // 2`` x model 2; model 1 for an odd count),
    then on one process from the same seed, and assert that the losses agree
    at rtol 1e-5. Returns both runs' losses, their final checkpoints (the
    single-card layout) and the ranks' mesh shapes."""

    from sparse_pooling_tpu_torch.data import synthetic
    from sparse_pooling_tpu_torch.parallel import launch
    from sparse_pooling_tpu_torch.runtime import checkpoint as ckpt_mod
    from sparse_pooling_tpu_torch.runtime.trainer import Trainer

    n_model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_model
    scratch = tempfile.mkdtemp(prefix="spt_dryrun_")
    try:
        root = os.path.join(scratch, "kitti")
        synthetic.write_kitti_tree(root, num_frames=n_data + 1, n_ground=512, n_obj=64, val_frames=(n_data,))
        cfg = dryrun_config(root, os.path.join(scratch, "experiments"), n_data, n_model)
        ranks = launch.spawn(train_rank, n_devices, (cfg, steps), timeout_s=timeout_s, threads=1)
        for r in ranks:
            assert r["mesh"] == {"data": n_data, "model": n_model}, r
        print(f"[dryrun] mesh {ranks[0]['mesh']}; stage2_head.fc1 shard {ranks[0]['fc1']}")
        sharded_dir = os.path.join(cfg.experiments_dir, cfg.checkpoint_name)
        sharded = losses_of(sharded_dir)

        single_cfg = dataclasses.replace(cfg, checkpoint_name=cfg.checkpoint_name + "_single",
                                         train=dataclasses.replace(cfg.train, data_parallel=False))
        single_trainer = Trainer(single_cfg, device="cpu")
        assert single_trainer.mesh is None
        single_trainer.train(max_steps=steps)
        single = losses_of(single_trainer.workdir)
        assert len(sharded) == len(single) == steps and all(np.isfinite(sharded)), (sharded, single)
        np.testing.assert_allclose(sharded, single, rtol=LOSS_RTOL,
                                   err_msg="sharded trajectory != single-process trajectory")
        print(f"[dryrun] production Trainer, {steps} steps on {n_devices} ranks: losses {sharded} == one "
              f"process's {single} (rtol {LOSS_RTOL:g})")
        return {
            "mesh": ranks[0]["mesh"], "fc1_shard": ranks[0]["fc1"],
            "sharded_losses": sharded, "single_losses": single,
            "sharded_state": ckpt_mod.restore(os.path.join(sharded_dir, "checkpoints"), steps, map_location="cpu"),
            "single_state": ckpt_mod.restore(single_trainer.ckpt_dir, steps, map_location="cpu"),
        }
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
