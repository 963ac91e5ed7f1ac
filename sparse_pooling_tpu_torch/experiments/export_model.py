"""Export a trained checkpoint as a self-contained serving artifact.

    python -m sparse_pooling_tpu_torch.experiments.export_model \
        --preset cars --workdir <experiments_dir> [--step N] \
        --out cars_b8.pt2 [--batch 8] [--device cuda] [--verify]

Port of ``sparse_pooling_tpu.experiments.export_model``: the batch forward +
decode traced by ``torch.export`` with the trained weights held in the
program, saved to one file and callable from any later process through
``runtime.export.load_serving_fn``, with no model code or checkpoint
plumbing at serving time. The artifact runs on the device type it was
exported for (``--device``, default ``cuda``; ``cpu`` runs the plain
PyTorch path).

Without ``--workdir`` the export uses seeded random weights
(``weights.init_like_flax``, seed 0) over a tree that
``data.synthetic.write_kitti_tree`` writes (an artifact-format smoke test).
``--verify`` loads the written file and checks its output against the live
pipeline on one batch of the split.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="cars")
    p.add_argument("--workdir", default=None, help="experiments dir with checkpoints")
    p.add_argument("--step", type=int, default=None, help="default: latest")
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("--verify", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Writes the artifact; returns {"step", "bytes", "export_s", "device"}
    (and "max_abs_err" with ``--verify``)."""

    args = parse_args(argv)
    import torch

    from sparse_pooling_tpu_torch import resolve_device, weights
    from sparse_pooling_tpu_torch.configs.config import AreaExtents
    from sparse_pooling_tpu_torch.configs.presets import preset
    from sparse_pooling_tpu_torch.data import synthetic
    from sparse_pooling_tpu_torch.data.dataset import KittiDataset
    from sparse_pooling_tpu_torch.models import pipeline as pl
    from sparse_pooling_tpu_torch.runtime import checkpoint as ckpt_mod
    from sparse_pooling_tpu_torch.runtime import export as export_mod

    cfg = preset(args.preset)
    ext = AreaExtents()
    dev = resolve_device(args.device)
    if args.workdir:
        cfg = dataclasses.replace(cfg, experiments_dir=args.workdir)
    else:  # random-init smoke export over a synthetic tree
        root = tempfile.mkdtemp(prefix="spt_export_") + "/kitti"
        synthetic.write_kitti_tree(root, num_frames=args.batch, val_frames=tuple(range(args.batch)))
        cfg = dataclasses.replace(cfg, experiments_dir=tempfile.mkdtemp(prefix="spt_export_exp_"),
                                  dataset=dataclasses.replace(cfg.dataset, root=root, split="val"))
    model = pl.make_model(cfg.model, ext, device=dev)
    step = args.step
    if args.workdir:
        ckpt_dir = os.path.join(cfg.experiments_dir, cfg.checkpoint_name, "checkpoints")
        step = step or ckpt_mod.latest_step(ckpt_dir)
        assert step is not None, f"no checkpoints under {ckpt_dir}"
        model.load_state_dict(ckpt_mod.restore(ckpt_dir, step, map_location="cpu")["model"])
        print(f"[export] restored step {step} from {ckpt_dir}")
    else:
        weights.init_like_flax(model, seed=0)

    t0 = time.perf_counter()
    ep = export_mod.export_inference(cfg, model, batch_size=args.batch, extents=ext, device=dev)
    export_s = time.perf_counter() - t0
    n = export_mod.save_exported(ep, args.out)
    print(f"[export] wrote {args.out}: {n / 1e6:.1f} MB, device={dev.type}, batch={args.batch}, "
          f"export {export_s:.1f} s")
    result = {"step": step, "bytes": n, "export_s": export_s, "device": dev.type}

    if args.verify:
        fn = export_mod.load_serving_fn(args.out)
        arrays, _ = next(KittiDataset(cfg.dataset, cfg.model, ext).batches(args.batch, 0, augment=False))
        batch = pl.RawSample(*(torch.from_numpy(a).to(dev) for a in arrays))
        got = fn(batch)
        anchors = pl.static_anchor_grid(cfg.model, ext, device=dev)
        want = pl.decode_batch(pl.forward_batch_fn(model, batch, anchors, cfg.model, ext), batch.ground_plane,
                               cfg.model, ext)
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        err = max(float((got[k].double() - want[k].double()).abs().max()) for k in want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)
        print(f"[export] verify OK: {sorted(want)} match the live pipeline (max abs err {err:.3e})")
        result["max_abs_err"] = err
    return result


if __name__ == "__main__":
    main()
