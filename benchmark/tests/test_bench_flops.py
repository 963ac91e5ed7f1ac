"""The analytic FLOP count against PyTorch's flop counter over the frozen
reference's forward, at small sizes of both families and both RPN crops."""

from __future__ import annotations

import pytest
import torch

from bench_fixtures import tiny_pipeline


def _counted(model, inputs) -> int:
    """FLOPs the counter gives the reference's conv and dense layers."""

    from torch.utils.flop_counter import FlopCounterMode

    from reference.layers import Conv, ConvTransposeSame, Dense

    layers = {name for name, m in model.named_modules() if isinstance(m, (Conv, ConvTransposeSame, Dense))}
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(inputs)
    root = type(model).__name__
    return sum(sum(ops.values()) for key, ops in counter.get_flop_counts().items()
               if key.startswith(root + ".") and key[len(root) + 1:] in layers)


@pytest.mark.parametrize("architecture,rpn_stride", [("avod", 1), ("avod", 2), ("rcnn", 1)])
def test_analytic_flops_match_the_flop_counter(architecture, rpn_stride):
    from harness.flops import forward_flops
    from harness.weights import seeded_state
    from reference import pipeline as rpl
    from reference.config import AreaExtents, pipeline_config_from_dict
    from traffic import frame_pool

    pipe = tiny_pipeline(architecture)
    pipe["model"]["rpn"]["bev_roi_stride"] = pipe["model"]["rpn"]["img_roi_stride"] = rpn_stride
    pipe["model"]["rpn"]["roi_channels"] = 4
    cfg = pipeline_config_from_dict(pipe).model
    ext = AreaExtents()
    model = rpl.make_model(cfg, ext, "cpu")
    model.load_state_dict(seeded_state(model, 5, "cpu"))
    frames = frame_pool({"pool_frames": 3, "points_min": 600, "points_max": 1000, "image": "noise"}, cfg, 5)
    batch = rpl.stack_frames(frames, cfg.sparse_pool.buckets, "cpu")
    inputs = rpl.build_model_inputs_batch(batch, rpl.static_anchor_grid(cfg, ext, "cpu"), torch.ones(3, 2),
                                          cfg, ext)
    assert _counted(model, inputs) == 3 * forward_flops(cfg, ext)


def test_published_sizes_count():
    """The two configurations' counts (JAX's algebraic count of the same
    graphs: about 246 and 253 GFLOP a frame)."""

    import json

    from conftest import BENCH
    from harness.flops import forward_flops
    from reference.config import AreaExtents, pipeline_config_from_dict

    got = {n: forward_flops(pipeline_config_from_dict(json.loads(
        (BENCH / "configs" / f"{n}.json").read_text())["pipeline"]).model, AreaExtents()) / 1e9
        for n in ("cars_pyramid", "rcnn_cars")}
    assert 230 < got["cars_pyramid"] < 250 and 240 < got["rcnn_cars"] < 260
