"""MV3D as published (``architecture="mv3d"``, ``models/mv3d.py``) against
the plain per-frame reference ``tests/mv3d_reference.py``, on seeded random
weights at a small size on the CPU: the front view, the BEV intensity, the
front-view box projection, the proposal lattice and its empty-anchor mask,
the deep-fusion join, and the whole serving forward and decode.

Tolerances: the inputs, the lattice, the mask and every NMS pick are exact
(integer rules, or float32 arithmetic the reference repeats). The model's
outputs are float32 on both sides and differ by the order of float32 sums
(the port's channels-last convolutions and batched matmuls against the
reference's per-frame ones): a largest gap of 2e-5 of the tensor's largest
value covers that with room, while bfloat16 anywhere in the head or the
crops moves them by 1e-3 or more. Geometry from float64 loops (the
front-view box) is held to 1e-3 pixel, 25x the float32 rounding of an
angle over a column's width.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

import mv3d_reference as ref
from sparse_pooling_tpu_torch.configs import presets
from sparse_pooling_tpu_torch.configs.config import (
    AnchorConfig,
    AreaExtents,
    AvodStage2Config,
    BackboneConfig,
    Mv3dConfig,
    Mv3dModelConfig,
    RpnConfig,
)
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame
from sparse_pooling_tpu_torch.models import pipeline as pl
from sparse_pooling_tpu_torch.models.backbone import space_to_depth
from sparse_pooling_tpu_torch.models.detector import Stage2Head, decode_detections
from sparse_pooling_tpu_torch.models.mv3d import bev_with_intensity, proposal_stride
from sparse_pooling_tpu_torch.ops import bev_device, encoders
from sparse_pooling_tpu_torch.ops.anchors import lattice_anchor_valid
from sparse_pooling_tpu_torch.ops.front_view import front_view_batch
from sparse_pooling_tpu_torch.ops.projection import project_to_bev, project_to_front_view

EXT = AreaExtents()
REL = 2e-5  # float32 sum order; bfloat16 moves the outputs by 1e-3 or more


def small_config() -> Mv3dModelConfig:
    """The unittest lattice (88x100 BEV at 0.8 m, 48x160 canvas, a
    two-stage backbone at stride 2 with the 2x2 packing) with MV3D's model:
    two anchor sizes on the 2x upsampled proposal lattice, a 16x64 front
    view, three FC layers fused deep, box_8c, float32."""

    base = presets.unittest_config().model
    return Mv3dModelConfig(
        architecture="mv3d", classes=("Car",), bev=base.bev, image=base.image, sparse_pool=base.sparse_pool,
        anchors=AnchorConfig(stride=base.bev.voxel_size, sizes=((3.9, 1.6, 1.56), (1.0, 0.6, 1.56))),
        backbone=BackboneConfig(channels=(8, 16), blocks=(1, 2), out_channels=8, compute_dtype="float32",
                                decode_stride=1, space_to_depth=True),
        rpn=dataclasses.replace(base.rpn, fusion_channels=16, pre_nms_top_k=64, eval_nms_size=12,
                                nms_iou_thresh=0.7),
        avod=AvodStage2Config(fc_layers=(24, 24, 24), nms_size=6, fusion_type="deep", box_rep="box_8c"),
        mv3d=Mv3dConfig(fv_height=16, fv_width=64),
    )


def frames(cfg, n: int = 2, points: int = 800, seed: int = 11):
    """Synthetic frames with a seeded intensity, and each frame's first 40
    points repeated at the end with another intensity (ties for every
    cell rule)."""

    out = []
    for k in range(n):
        f = synthetic_frame(cfg, n_points=points, seed=seed + k, image="noise")
        rng = np.random.default_rng([seed, k])
        pts = np.concatenate([f["points"], np.zeros((f["points"].shape[0], 1), np.float32)], axis=1)
        pts[:points, 3] = rng.random(points, dtype=np.float32)
        pts[points:points + 40, :3] = pts[:40, :3]
        pts[points:points + 40, 3] = rng.random(40, dtype=np.float32)
        mask = f["points_mask"].copy()
        mask[points:points + 40] = True
        out.append(dict(f, points=pts, points_mask=mask))
    return out


@pytest.fixture(scope="module")
def served():
    """The port's serving path on two frames at the small config, seeded
    random weights: inputs, outputs, detections, the RPN's NMS result."""

    from sparse_pooling_tpu_torch.models import detector

    cfg = small_config()
    model = pl.make_model(cfg, EXT, device="cpu")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (p.shape[1:].numel() ** -0.5 if p.dim() > 1 else 0.1))
    batch = pl.stack_frames(frames(cfg), device="cpu")
    anchors = pl.static_anchor_grid(cfg, EXT, device="cpu")
    kept, nms = {}, detector.top_k_nms_batch

    def recorded(*args, **kwargs):
        kept["rpn"] = nms(*args, **kwargs)
        return kept["rpn"]

    detector.top_k_nms_batch = recorded
    try:
        with torch.no_grad():
            inputs = pl.build_model_inputs_batch(batch, anchors, torch.ones(2, 2), cfg, EXT)
            out = model(inputs)
            det = pl.decode_batch(out, batch.ground_plane, cfg, EXT)
    finally:
        detector.top_k_nms_batch = nms
    state = {k: v.detach() for k, v in model.state_dict().items()}
    return cfg, batch, inputs, out, det, state, kept["rpn"]


def rel_gap(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def test_front_view_matches_the_loops(served):
    cfg, batch, inputs = served[:3]
    for k in range(2):
        want = ref.front_view(batch.points[k], batch.points_mask[k], batch.ground_plane[k], cfg.mv3d)
        assert torch.equal(inputs["fv_input"][k], want)
    filled = (inputs["fv_input"][..., 1] > 0).sum().item()
    assert 100 < filled < inputs["fv_input"][..., 0].numel()


def test_front_view_ties_go_to_the_lowest_index(served):
    """The repeated points tie with their first copies in distance: the
    first copy's intensity stays."""

    cfg, batch, inputs = served[:3]
    row, col, rho = ref.fv_cells(batch.points[0], cfg.mv3d)
    kept = 0
    for i in range(40):
        r, c = int(row[i]), int(col[i])
        if 0 <= r < cfg.mv3d.fv_height and 0 <= c < cfg.mv3d.fv_width and inputs["fv_input"][0, r, c, 1] == rho[i]:
            kept += 1
            assert inputs["fv_input"][0, r, c, 2] == batch.points[0, i, 3] != batch.points[0, 800 + i, 3]
    assert kept > 5


def test_front_view_cells_follow_the_cylinder():
    """The float32 cell formula against float64 geometry: equal apart from
    points within 1e-4 of a cell's edge, where float32's rounding of the
    angle may put them either side; a point straight ahead at the camera's
    height lies in column W/2 - 1 and row fv_top - 1."""

    fv = Mv3dConfig()
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(-30, 30, 4000), rng.uniform(-1, 2.5, 4000), rng.uniform(1, 70, 4000)], 1)
    row, col, _ = ref.fv_cells(torch.from_numpy(pts.astype(np.float32)), fv)
    dtheta, dphi = fv.fv_steps
    p32 = pts.astype(np.float32).astype(np.float64)
    t = np.arctan2(-p32[:, 0], p32[:, 2]) / dtheta
    e = np.arctan2(-p32[:, 1], np.hypot(p32[:, 2], p32[:, 0])) / dphi
    edge = (np.abs(t - np.round(t)) < 1e-4) | (np.abs(e - np.round(e)) < 1e-4)
    want_col = fv.fv_width // 2 - 1 - np.floor(t)
    want_row = fv.fv_top - 1 - np.floor(e)
    agree = (col.numpy() == want_col) & (row.numpy() == want_row)
    assert (agree | edge).all() and edge.sum() < 10
    r, c, _ = ref.fv_cells(torch.tensor([[0.0, 0.0, 10.0]]), fv)
    assert (int(r), int(c)) == (fv.fv_top - 1, fv.fv_width // 2 - 1)
    fv_map = front_view_batch(torch.tensor([[[0.0, 0.0, 10.0, 0.25]]]), torch.tensor([[True]]),
                              torch.tensor([[0.0, -1.0, 0.0, 1.65]]), fv)
    assert fv_map[0, fv.fv_top - 1, fv.fv_width // 2 - 1].tolist() == pytest.approx([1.65, 10.0, 0.25])
    assert fv_map.abs().sum().item() == pytest.approx(1.65 + 10.0 + 0.25)


def test_bev_intensity_matches_the_loops(served):
    cfg, batch, inputs = served[:3]
    for k in range(2):
        want = ref.bev_intensity(batch.points[k], batch.points_mask[k], batch.ground_plane[k], EXT, cfg.bev)
        assert torch.equal(inputs["bev_intensity"][k], want)
    assert (inputs["bev_intensity"] > 0).sum().item() > 100


def test_the_packed_bev_input_is_the_packed_joined_map(served):
    cfg, batch, inputs = served[:3]
    unpacked = bev_device.bev_maps_from_points_batch(batch.points, batch.points_mask, batch.ground_plane, EXT,
                                                     cfg.bev)
    assert inputs["bev_pre_packed"]
    joined = bev_with_intensity(inputs["bev_input"], inputs["bev_intensity"], True)
    assert torch.equal(joined, space_to_depth(torch.cat([unpacked, inputs["bev_intensity"]], dim=-1)))
    assert torch.equal(bev_with_intensity(unpacked, inputs["bev_intensity"], False),
                       torch.cat([unpacked, inputs["bev_intensity"]], dim=-1))


def test_project_to_front_view():
    """Boxes ahead, to the sides and near the sensor (clipped) against the
    corners' float64 loop."""

    fv = Mv3dConfig()
    rng = np.random.default_rng(5)
    n = 300
    anchors = np.stack([rng.uniform(-35, 35, n), rng.uniform(1.0, 2.0, n), rng.uniform(0.5, 60, n),
                        rng.uniform(0.5, 5, n), rng.uniform(1.0, 2.0, n), rng.uniform(0.5, 5, n)], 1)
    got = project_to_front_view(torch.from_numpy(anchors.astype(np.float32)), fv)
    want = torch.tensor([ref.fv_box(a, fv) for a in anchors.astype(np.float32).astype(np.float64).tolist()])
    assert (got.double() - want.double()).abs().max().item() < 1e-3
    clipped = (got[:, 1] == 0) | (got[:, 3] == fv.fv_width - 1) | (got[:, 2] == fv.fv_height - 1)
    assert 0 < clipped.sum() < n
    assert ((got[:, 2] >= got[:, 0]) & (got[:, 3] >= got[:, 1])).all()


def test_anchor_lattice_and_mask_at_the_published_sizes():
    """The mv3d_cars lattice (176x200 cells of 0.4 m, four anchors each:
    140,800) and its mask over a frame's occupancy, the padded row empty."""

    cfg = presets.mv3d_cars_config().model
    stride = proposal_stride(cfg)
    grid = pl.static_anchor_grid(cfg, EXT, device="cpu")
    assert stride == 4 and grid.shape == (140_800, 8)
    assert np.array_equal(grid.numpy(), ref.anchor_lattice(cfg, EXT, stride))
    f = synthetic_frame(cfg, n_points=6000, seed=3)
    counts = bev_device.bev_counts_from_points(torch.from_numpy(f["points"])[None],
                                               torch.from_numpy(f["points_mask"])[None], EXT, cfg.bev.voxel_size)
    occupied = (counts > 0).to(torch.float32)
    valid = lattice_anchor_valid(occupied, EXT, cfg.bev, cfg.anchors, stride)[0]
    want = ref.anchor_mask(occupied[0].numpy(), cfg, EXT, stride)
    assert np.array_equal(valid.numpy(), want)
    assert 0.05 < want.mean() < 0.95 and not want.reshape(176, 200, 4)[175].any()


def test_stage2_head_is_the_papers_join():
    """``Stage2Head(fusion_type="deep", n_views=3)`` computes f0 = the mean
    of the three views, f_l = the mean of the views' relu(fc_l^v(f_(l-1))),
    and its heads read f3; without a view the join moves."""

    torch.manual_seed(0)
    head = Stage2Head(20, (16, 16, 16), 1, torch.float32, box_dim=24, flip_head=True, fusion_type="deep",
                      fusion_method="mean", n_views=3)
    views = [torch.randn(2, 5, 20) for _ in range(3)]
    seen = {}
    head.join.register_forward_hook(lambda m, a, o: seen.setdefault("join", o))
    cls, box, orient, flip = head([v.reshape(2, 5, 2, 2, 5) for v in views], 3.0)
    state = head.state_dict()
    want = ref.deep_fusion(views, {f"stage2_head.{k}": v for k, v in state.items()}, 3)
    assert rel_gap(seen["join"], want) < 1e-6
    assert rel_gap(cls, ref.dense(want, {f"stage2_head.{k}": v for k, v in state.items()}, "stage2_head.cls")) < 1e-6
    assert rel_gap(ref.deep_fusion(views[:2], {f"stage2_head.{k}": v for k, v in state.items()}, 3), want) > 1e-2


def test_serving_forward_and_decode(served):
    """The whole serving forward of each frame against the reference's:
    the RPN, the anchor mask, the RPN picks (the greedy NMS over the port's
    scores, and those scores against the reference's), the three views'
    crops, the join and the heads at the picks, then the final picks and
    boxes decoded from the reference's heads."""

    cfg, batch, inputs, out, det, state, rpn = served
    stride = proposal_stride(cfg)
    refs = []
    for k in range(2):
        unpacked = bev_device.bev_maps_from_points_batch(batch.points[k:k + 1], batch.points_mask[k:k + 1],
                                                         batch.ground_plane[k:k + 1], EXT, cfg.bev)[0]
        occupied = unpacked[:cfg.bev.grid_hw(EXT)[0], :, cfg.bev.height_slices] > 0
        assert np.array_equal(inputs["anchor_valid"][k].numpy(),
                              ref.anchor_mask(occupied.numpy(), cfg, EXT, stride))
        port_picks = rpn.indices[k][rpn.valid[k]].tolist()
        frame_in = {
            "bev": unpacked, "intensity": inputs["bev_intensity"][k],
            "fv": ref.front_view(batch.points[k], batch.points_mask[k], batch.ground_plane[k], cfg.mv3d),
            "image": inputs["image"][k], "m_bev": _frame_coo(inputs["m_bev"], k),
            "m_fv": _frame_coo(inputs["m_fv"], k), "anchors": inputs["anchors"][k],
            "anchor_valid": inputs["anchor_valid"][k], "p2": batch.p2[k],
        }
        got = ref.forward(frame_in, state, cfg, EXT, port_picks)
        refs.append(got)
        assert rel_gap(out["objectness"][k], got["objectness"]) < REL
        assert rel_gap(out["rpn_offsets"][k], got["rpn_offsets"]) < REL
        port_scores = torch.where(inputs["anchor_valid"][k], torch.softmax(out["objectness"][k], -1)[:, 1],
                                  -math.inf)
        assert torch.equal(torch.isinf(port_scores), torch.isinf(got["scores"]))
        finite = torch.isfinite(got["scores"])
        assert (port_scores[finite] - got["scores"][finite]).abs().max() < 1e-6
        prop_bev = project_to_bev(encoders.offset_to_anchor(inputs["anchors"][k][:, :6], out["rpn_offsets"][k]),
                                  EXT)
        assert port_picks == ref.greedy_nms(prop_bev, port_scores, cfg.rpn.eval_nms_size, cfg.rpn.nms_iou_thresh,
                                            cfg.rpn.pre_nms_top_k)
        assert len(port_picks) == cfg.rpn.eval_nms_size
        assert rel_gap(out["proposals"][k], got["proposals"]) < REL
        for name in ("cls_logits", "box_offsets", "orientation", "flip_logits"):
            assert rel_gap(out[name][k], got[name]) < REL, name

    ref_out = {name: torch.stack([r[name] for r in refs]) for name in
               ("proposals", "cls_logits", "box_offsets", "orientation", "flip_logits")}
    ref_det = decode_detections(dict(ref_out, proposal_valid=out["proposal_valid"]), batch.ground_plane, cfg, EXT)
    assert torch.equal(det["valid"], ref_det["valid"]) and det["valid"].any()
    valid = det["valid"]
    assert (det["boxes_3d"][valid] - ref_det["boxes_3d"][valid]).abs().max() < 1e-4
    assert (det["scores"][valid] - ref_det["scores"][valid]).abs().max() < 1e-6


def _frame_coo(coo, k):
    return dataclasses.replace(coo, rows=coo.rows[k:k + 1], cols=coo.cols[k:k + 1], vals=coo.vals[k:k + 1])
