"""ContFuse (``architecture="contfuse"``, ``models/contfuse.py``) against the
plain float32 reference ``tests/contfuse_reference.py``, on seeded random
weights at a small size on the CPU: the inputs (the occupancy map, the
points' canvas coordinates, the lattice centres, the KNN tables), each
continuous-fusion layer, the header's input features, and the decoded boxes
and scores at the port's NMS picks; the input build of the other families
unchanged by the family's own (nothing of SHPL built for ContFuse only).

Tolerances: the inputs are exact (integer rules, or float32 arithmetic the
reference repeats op for op), the KNN tables bit for bit. The model runs in
float32 on both sides; its outputs differ by the order of float32 sums (the
port's gathers feed one matmul over every neighbour slot, the reference's a
matmul per frame and slot; PyTorch's CPU convolutions block their sums by
shape): a largest gap of 2e-5 of the tensor's largest value covers that
with room, while bfloat16 anywhere moves them by 1e-3 or more.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import contfuse_reference as ref
from sparse_pooling_tpu_torch.configs import presets
from sparse_pooling_tpu_torch.configs.config import (
    AreaExtents,
    BevConfig,
    ContfuseConfig,
    ImageConfig,
    SparsePoolConfig,
)
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame
from sparse_pooling_tpu_torch.models import detector
from sparse_pooling_tpu_torch.models import pipeline as pl

EXT = AreaExtents()
REL = 2e-5  # float32 sum order; bfloat16 moves the outputs by 1e-3 or more


def small_config():
    """An 80x80 BEV at 1 m (70 rows and 10 of padding, so that it halves
    four times), a 64x160 canvas, ContFuse's streams at widths of 4-8,
    float32; the 3 neighbours, the 10 m limit and the box coding of the
    preset."""

    base = presets.contfuse_cars_config().model
    return dataclasses.replace(
        base, bev=BevConfig(voxel_size=1.0, pad_h=10), image=ImageConfig(height=64, width=160),
        anchors=dataclasses.replace(base.anchors, stride=4.0), sparse_pool=SparsePoolConfig(max_points=1024),
        backbone=dataclasses.replace(base.backbone, compute_dtype="float32"),
        avod=dataclasses.replace(base.avod, nms_size=12),
        contfuse=ContfuseConfig(bev_layers=(1, 2, 2, 2, 4), bev_channels=(4, 8, 8, 12, 16), fpn_channels=8,
                                image_blocks=(1, 1, 1, 1), image_channels=(8, 8, 12, 16), image_feature_channels=8))


def frames(cfg, n: int = 2, points: int = 800, seed: int = 21):
    """Synthetic frames with a seeded intensity, and each frame's first 30
    points repeated at its end (ties for the KNN and the cell rules)."""

    out = []
    for k in range(n):
        f = synthetic_frame(cfg, n_points=points, seed=seed + k, image="noise")
        rng = np.random.default_rng([seed, k])
        pts = np.concatenate([f["points"], np.zeros((f["points"].shape[0], 1), np.float32)], axis=1)
        pts[:points, 3] = rng.random(points, dtype=np.float32)
        pts[points:points + 30, :3] = pts[:30, :3]
        pts[points:points + 30, 3] = rng.random(30, dtype=np.float32)
        mask = f["points_mask"].copy()
        mask[points:points + 30] = True
        out.append(dict(f, points=pts, points_mask=mask))
    return out


def seeded(model, seed: int = 7):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (p.shape[1:].numel() ** -0.5 if p.dim() > 1 else 0.1))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class Hooks:
    def __init__(self, model, names):
        self.out = {}
        mods = dict(model.named_modules())
        for name in names:
            mods[name].register_forward_hook(lambda m, a, o, name=name: self.out.__setitem__(name, o))


LAYERS = ("fusion1", "fusion2", "fusion3", "fusion4", "head_input")


@pytest.fixture(scope="module")
def served():
    """The port's serving path on two frames at the small config and the
    reference on the same inputs and weights."""

    cfg = small_config()
    model = pl.make_model(cfg, EXT, device="cpu")
    state = seeded(model)
    port_hooks = Hooks(model, LAYERS)
    batch = pl.stack_frames(frames(cfg), device="cpu")
    anchors = pl.static_anchor_grid(cfg, EXT, device="cpu")
    picks, nms = [], detector.nms_batch

    def recorded(*args, **kwargs):
        picks.append(nms(*args, **kwargs))
        return picks[-1]

    detector.nms_batch = recorded
    try:
        with torch.no_grad():
            inputs = pl.build_model_inputs_batch(batch, anchors, torch.ones(2, 2), cfg, EXT)
            out = model(inputs)
            det = pl.decode_batch(out, batch.ground_plane, cfg, EXT)
    finally:
        detector.nms_batch = nms
    reference = ref.ContFuse(cfg, EXT)
    reference.load_state_dict(state)
    ref_hooks = Hooks(reference, LAYERS)
    with torch.no_grad():
        ref_inputs = dict(ref.extra_inputs(batch, cfg, EXT), image=inputs["image"],
                          anchors=inputs["anchors"], anchor_valid=inputs["anchor_valid"])
        ref_out = reference(ref_inputs)
    return cfg, batch, inputs, out, det, picks, port_hooks.out, ref_inputs, ref_out, ref_hooks.out


def rel_gap(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def test_the_family_builds_no_shpl_table(served):
    """No SHPL table, no height-slice maps: the family builds what it reads."""

    cfg, _, inputs = served[:3]
    assert not {"m_bev", "m_fv", "bev_input", "bev_pre_packed"} & set(inputs)
    assert pl.family(cfg).frame_inputs_wait_free


@pytest.mark.parametrize("key", ["bev_occupancy", "points", "points_uv", "knn_centres", "knn"])
def test_inputs_match_the_reference(served, key):
    _, _, inputs, *_, ref_inputs, _, _ = served
    assert inputs[key].dtype == ref_inputs[key].dtype and torch.equal(inputs[key], ref_inputs[key]), key


def test_inputs_are_not_trivial(served):
    cfg, batch, inputs = served[:3]
    occ = inputs["bev_occupancy"]
    n = int(round((cfg.contfuse.height_hi - cfg.contfuse.height_lo) / cfg.bev.voxel_size))
    assert occ.shape == (2, 80, 80, n + 1) and 20 < (occ[..., :n] > 0).sum() < occ[..., :n].numel() / 4
    assert (occ[..., n] > 0).sum() > 20 and set(occ[..., :n].unique().tolist()) == {0.0, 1.0}
    knn, p = inputs["knn"], batch.points.shape[1]
    assert knn.shape == (2, 40 * 40 + 20 * 20 + 10 * 10 + 5 * 5, 3)
    assert (knn < p).any() and (knn == p).any()  # pixels with and without points in 10 m
    # a repeated point ties with its first copy: the first copy's index comes first
    assert not ((knn[..., :-1] >= 800) & (knn[..., :-1] < 830) & (knn[..., 1:] == knn[..., :-1] - 800)).any()


@pytest.mark.parametrize("layer", LAYERS)
def test_fusion_layers_and_header_input_match(served, layer):
    port_hooks, ref_hooks = served[6], served[9]
    assert port_hooks[layer].shape == ref_hooks[layer].shape
    assert ref_hooks[layer].abs().max() > 0
    assert rel_gap(port_hooks[layer], ref_hooks[layer]) < REL, layer


def test_decoded_boxes_and_scores_at_the_port_picks(served):
    cfg, _, _, out, det, picks, _, _, ref_out, _ = served
    assert len(picks) == cfg.num_classes == 1
    boxes = ref.decode_boxes(ref_out["anchors"], ref_out["box_deltas"], cfg.anchors.rotations)
    probs = torch.softmax(ref_out["cls_logits"], dim=-1)[..., 1]
    idx, valid = picks[0]
    assert valid.all() and det["valid"][:, 0].equal(valid)
    want_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 7))
    assert rel_gap(det["boxes_3d"][:, 0], want_boxes) < REL
    assert rel_gap(det["scores"][:, 0], torch.gather(probs, 1, idx)) < REL
    assert rel_gap(out["box_deltas"], ref_out["box_deltas"]) < REL


def test_decode_matches_the_box_coding():
    """A hand case: an anchor at 90 deg, its length along z."""

    from sparse_pooling_tpu_torch.models.contfuse import decode_boxes

    anchor = torch.tensor([[1.0, 1.6, 20.0, 1.6, 1.5, 3.9, 1.0, 0.0]])
    deltas = torch.tensor([[1.0, -1.0, 0.5, 0.0, np.log(2.0) / 0.2, 0.0, 1.0]])
    box = decode_boxes(anchor, deltas, (0.0, np.pi / 2))[0]
    d = np.hypot(3.9, 1.6)
    want = [1.0 + 0.1 * d, 1.6 - 0.1 * 1.5, 20.0 + 0.05 * d, 3.9, 3.2, 1.5, np.pi / 2 + 0.1]
    assert np.allclose(box.numpy(), want, atol=1e-5)


def test_the_served_nms_sees_every_anchor(served):
    cfg, _, inputs = served[:3]
    assert inputs["anchors"].shape[1] == 20 * 20 * 2 and inputs["anchor_valid"].all()


@pytest.mark.parametrize("architecture", ["rcnn", "mv3d"])
def test_other_families_build_their_inputs_as_before(architecture):
    """rcnn and MV3D still build both SHPL tables and the height-slice maps,
    equal to the builders' own, bit for bit."""

    from test_torch_families import small, small_frames

    cfg = small(architecture)
    batch = pl.stack_frames(small_frames(cfg), device="cpu")
    anchors = pl.static_anchor_grid(cfg, EXT, device="cpu")
    with torch.no_grad():
        built = pl.build_model_inputs_batch(batch, anchors, torch.ones(2, 2), cfg, EXT)
    from sparse_pooling_tpu_torch.ops import bev_device, sparse_build

    args = (batch.points, batch.points_mask, batch.ground_plane, EXT, cfg.bev)
    maps = (bev_device.bev_maps_packed_batch(*args)[0] if built["bev_pre_packed"]
            else bev_device.bev_maps_from_points_batch(*args))
    assert torch.equal(built["bev_input"], maps)

    m_bev, m_fv = sparse_build.build_coo_device(batch.points, batch.points_mask, batch.p2, EXT, cfg.bev, cfg.image,
                                                cfg.sparse_pool)
    for got, want in ((built["m_bev"], m_bev), (built["m_fv"], m_fv)):
        for f in ("rows", "cols", "vals"):
            assert torch.equal(getattr(got, f), getattr(want, f))
    assert "knn" not in built and "bev_occupancy" not in built
