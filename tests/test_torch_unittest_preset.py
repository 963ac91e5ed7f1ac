"""The ``unittest`` preset end to end, PyTorch port against the JAX package
on the CPU.

The preset every JAX runtime test runs combines several model options: the
position-granular anchor filter (``roi_quad`` 1 over an 88 x 100 lattice at
0.8 m), reference-exact stride-1 RPN crops, the unpacked voxelizer
(``space_to_depth`` off) and full-resolution decoders (``decode_stride`` 1),
a two-stage backbone. Two in-memory frames at its 48 x 160 canvas go through
``make_model``, ``forward_batch_fn`` and ``decode_batch`` of both packages
(the JAX init carried over by ``weights.from_flax``), then one training step
(path drop off and dropout's keep probability 1, so neither package draws;
serving reads neither). Tolerances as ``tests/test_torch_options_rpn.py``:
outputs to 1e-4 of their largest value, masks equal, loss terms to 1e-4,
every gradient to 1e-4 of its parameter's largest.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports flax

from sparse_pooling_tpu_torch.configs import AreaExtents  # noqa: E402
from sparse_pooling_tpu_torch.configs.presets import unittest_config  # noqa: E402
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame  # noqa: E402
from sparse_pooling_tpu_torch.models import detector as t_det  # noqa: E402
from sparse_pooling_tpu_torch.models import pipeline as t_pl  # noqa: E402
from test_torch_options_rpn import (  # noqa: E402
    FLOAT_OUTPUTS,
    TERMS,
    both,
    check_detections,
    check_gradients,
    check_loss,
    check_masks,
    check_outputs,
)

EXT = AreaExtents()
r = dataclasses.replace


def preset_model_config():
    cfg = unittest_config().model
    return r(cfg, avod=r(cfg.avod, keep_dropout_prob=1.0), path_drop=r(cfg.path_drop, enabled=False))


def preset_frames(cfg):
    """Two frames with ``gt_boxes_3d[0]`` moved onto a kept anchor (a car on
    the ground at a 4 m anchor position), so the RPN minibatch holds a
    positive: the preset's coarse grid rarely meets a box placed on the
    points."""

    frames = [synthetic_frame(cfg, n_points=1024, seed=s, image="noise") for s in (2, 3)]
    batch = t_pl.stack_frames(frames, device="cpu")
    inputs = t_pl.build_model_inputs_batch(batch, t_pl.static_anchor_grid(cfg, EXT, device="cpu"),
                                           torch.ones(2, 2), cfg, EXT)
    for f, anchors, valid in zip(frames, inputs["anchors"], inputs["anchor_valid"]):
        kept = torch.nonzero(valid[0::2]).flatten()  # rotation 0: dim_x is the length
        x, y, z, dx, dy, dz = anchors[2 * kept[len(kept) // 2], :6].tolist()
        f["gt_boxes_3d"][0] = [x, y, z, dx, dz, dy, 0.0]
    return frames


@pytest.fixture(scope="module")
def preset_run():
    cfg = preset_model_config()
    return both(cfg, EXT, frames=preset_frames(cfg))


def test_the_preset_runs_the_options():
    cfg = unittest_config().model
    assert cfg.rpn.roi_quad == 1 and not cfg.rpn.dense_grid
    assert cfg.rpn.bev_roi_stride == cfg.rpn.img_roi_stride == 1
    assert not cfg.backbone.space_to_depth and cfg.backbone.decode_stride == 1
    assert (cfg.image.height, cfg.image.width) == (48, 160) and cfg.bev.grid_hw(EXT) == (88, 100)


def test_preset_model(preset_run):
    model = preset_run["port"]["model"]
    assert isinstance(model, t_det.SparsePoolingDetector)
    assert not hasattr(model, "bev_roi_proj") and model.bev_group == 1
    out = preset_run["port"]["out"]
    assert out["anchors"].shape == (2, 128, 8) and out["proposals"].shape == (2, 16, 6)
    # whole positions kept: both rotations of a position side by side
    a = out["anchors"].numpy()
    np.testing.assert_array_equal(a[:, 0::2, [0, 2]], a[:, 1::2, [0, 2]])


@pytest.mark.parametrize("key", FLOAT_OUTPUTS)
def test_preset_outputs_match_jax(preset_run, key):
    check_outputs(preset_run, key)


@pytest.mark.parametrize("key", ["anchor_valid", "proposal_valid"])
def test_preset_masks_match_jax(preset_run, key):
    check_masks(preset_run, key)


def test_preset_detections_match_jax(preset_run):
    check_detections(preset_run)


@pytest.mark.parametrize("term", TERMS)
def test_preset_train_step_losses_match_jax(preset_run, term):
    check_loss(preset_run, term, positives=("num_rpn_pos", "rpn_regression"))


def test_preset_train_step_gradients_match_jax(preset_run):
    check_gradients(preset_run)
