"""``pipeline.stack_frames``, the serving path's upload: each field stacked
in one host pass into a fresh staging tensor, page-locked and copied without
a wait on a card, the staging tensor itself on the CPU; ``upload_counts``
says which way each field went.

Runs without JAX (``pytest --noconftest tests/test_torch_pipeline_upload.py``
on a machine with a card). The card tests skip where
``torch.cuda.is_available()`` is false.
"""

import numpy as np
import pytest
import torch

from sparse_pooling_tpu_torch.configs import cars_pyramid_config
from sparse_pooling_tpu_torch.configs.presets import mv3d_cars_config, rcnn_cars_config
from sparse_pooling_tpu_torch.data.pointcloud import trim_points_to_bucket
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame
from sparse_pooling_tpu_torch.models import pipeline as pl

CONFIGS = {"rcnn": rcnn_cars_config, "mv3d": mv3d_cars_config, "cars": cars_pyramid_config}
DTYPES = {"points": torch.float32, "points_mask": torch.bool, "image": torch.uint8, "p2": torch.float32,
          "ground_plane": torch.float32, "gt_boxes_3d": torch.float32, "gt_valid": torch.bool,
          "gt_classes": torch.int32, "image_scale": torch.float32}


def frames(family, n, points, seed):
    """``n`` noise-image frames of the family's preset, the points trimmed to
    the smallest bucket that holds them as the serving harness does; mv3d's
    points carry a seeded intensity as a fourth column."""

    cfg = CONFIGS[family]().model
    out = []
    for k in range(n):
        f = synthetic_frame(cfg, points, seed + k, image="noise")
        if family == "mv3d":
            intensity = np.random.default_rng([seed, k]).random(len(f["points"]), dtype=np.float32)
            f["points"] = np.concatenate([f["points"], (intensity * f["points_mask"])[:, None]], axis=1)
        out.append(f)
    pts, mask = trim_points_to_bucket(np.stack([f["points"] for f in out]),
                                      np.stack([f["points_mask"] for f in out]), cfg.sparse_pool.buckets)
    return [dict(f, points=p, points_mask=m) for f, p, m in zip(out, pts, mask)]


def stacked(frs, name):
    """The field as the upload used to make it: one ``np.stack``."""

    return torch.from_numpy(np.stack([f[name] for f in frs]))


def delta(before):
    after = pl.upload_counts()
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_stack_frames_stages_every_field_plainly_on_the_cpu(family):
    """Every field bit-equal to ``np.stack`` with its dtype, ``None`` fields
    kept, no storage shared between two calls nor with the frames, each
    field and its bytes counted as staged plainly."""

    first, second = frames(family, 2, 600, 3), frames(family, 2, 600, 5)
    assert first[0]["points"].shape[0] == min(CONFIGS[family]().model.sparse_pool.buckets)
    assert first[0]["points"].shape[1] == (4 if family == "mv3d" else 3)
    before = pl.upload_counts()
    a = pl.stack_frames(first, device="cpu")
    counted = delta(before)
    b = pl.stack_frames(second, device="cpu")
    for batch, frs in ((a, first), (b, second)):
        for name in pl.RawSample._fields:
            got, want = getattr(batch, name), stacked(frs, name)
            assert got.device.type == "cpu" and got.dtype == want.dtype == DTYPES[name], name
            assert torch.equal(got, want), name
            assert not any(np.shares_memory(got.numpy(), f[name]) for f in frs), name
    ptrs = {t.untyped_storage().data_ptr() for batch in (a, b) for t in batch}
    assert len(ptrs) == 2 * len(pl.RawSample._fields)
    nbytes = sum(stacked(first, name).nbytes for name in pl.RawSample._fields)
    assert counted == {"pinned_fields": 0, "pinned_bytes": 0,
                       "plain_fields": len(pl.RawSample._fields), "plain_bytes": nbytes}

    before = pl.upload_counts()
    c = pl.stack_frames([{k: v for k, v in f.items() if k != "image_scale"} for f in first], device="cpu")
    assert c.image_scale is None and torch.equal(c.image, a.image)
    assert delta(before)["plain_fields"] == len(pl.RawSample._fields) - 1


@pytest.mark.parametrize("field", ["points", "image", "gt_boxes_3d"])
def test_stack_frames_refuses_frames_of_mismatched_shapes(field):
    frs = frames("rcnn", 2, 600, 3)
    frs[1] = dict(frs[1], **{field: frs[1][field][:-1]})
    with pytest.raises(ValueError, match="same shape"):
        pl.stack_frames(frs, device="cpu")


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (pinned memory and asynchronous copies)")
    return torch.device("cuda")


def full_size(family, seed):
    """A serving request's 8 frames at the cell's sizes: 20,000 points a
    frame, so the 32768 bucket, and the preset's whole canvas."""

    return frames(family, 8, 20000, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["rcnn", "mv3d"])
def test_stack_frames_on_card_matches_the_pageable_copy_and_pins(cuda, family):
    frs = full_size(family, 40)
    before = pl.upload_counts()
    batch = pl.stack_frames(frs, device=cuda)
    counted = delta(before)
    for name in pl.RawSample._fields:
        got = getattr(batch, name)
        assert got.is_cuda and got.dtype == DTYPES[name], name
        assert torch.equal(got, stacked(frs, name).to(cuda)), name
    nbytes = sum(stacked(frs, name).nbytes for name in pl.RawSample._fields)
    assert counted == {"pinned_fields": len(pl.RawSample._fields), "pinned_bytes": nbytes,
                       "plain_fields": 0, "plain_bytes": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["rcnn", "mv3d"])
def test_back_to_back_uploads_on_card_keep_their_own_frames(cuda, family):
    """Three calls with different frames while the stream is held by a
    spin, so every copy is still queued when the next call stages: a pinned
    block handed out again before its copy ran would show in an earlier
    call's tensors. Twice, the second time from the allocator's cache."""

    requests = [full_size(family, 100 * r) for r in range(3)]
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000_000)
        batches = [pl.stack_frames(frs, device=cuda) for frs in requests]
        torch.cuda.synchronize()
        for batch, frs in zip(batches, requests):
            for name in pl.RawSample._fields:
                assert torch.equal(getattr(batch, name).cpu(), stacked(frs, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["rcnn", "mv3d"])
def test_warmed_upload_on_card_waits_for_nothing(cuda, family):
    frs = full_size(family, 7)
    pl.stack_frames(frs, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch = pl.stack_frames(frs, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for name in pl.RawSample._fields:
        assert torch.equal(getattr(batch, name).cpu(), stacked(frs, name)), name
