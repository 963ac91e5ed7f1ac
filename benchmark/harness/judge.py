"""Whether the served detections are correct: the timed path's records held
against the plain float32 reference (``reference/``), which recomputes every
stage from the same host frames and the same weights.

The NMS picks are discrete: at each pick the reference is handed the port's
choice, as a served token is handed to a language model's reference, and the
judge reads how far the picked candidate's reference score lies below the best
candidate the reference still holds. Suppression is read from the reference's
own boxes, and a candidate whose IoU with a pick lies within ``IOU_MARGIN`` of
the threshold is left out of the competition: rounding moves an IoU that far,
and either side of the threshold is then right. Stage 2 runs in the reference
on the port's RPN picks and crops at the port's proposal boxes, and the final
boxes are decoded from those proposals at the port's final picks: a box that
lies near the image plane projects ill-conditioned, and crops at boxes that
differ by rounding then differ by far more. The reference's own proposals at
the port's picks are compared with the port's on their own (``proposals``).

The heads' logits of randomly drawn weights are small (an objectness logit's
RMS is 0.004-0.014, set by the seed's draw), so a relative gap of the logits
swings from seed to seed with that scale; the hidden features that feed the
heads carry the same work and do not. The heads themselves are held by the
picks, the proposals, the boxes, the heading and the scores.

The heading is read in two parts, as both families decode it: its line
(``ry`` modulo pi, from the box's corners in the AVOD family and from
``atan2`` of the orientation vector in the rcnn family) and its side (the
flip head's argmax, which adds pi). ``atan2`` of a small vector is
ill-conditioned, so where the line comes from the vector only the detections
whose reference vector is at least ``HEADING_SHARE`` times its frame's median
over the valid proposals are read. The side is a discrete pick, read as the
picks are: how far the reference's flip logit of the port's side lies below
its best.

The numbers compared, each the widest over the sampled requests:
  inputs     model inputs (BEV maps, image, anchors, the shared ones the
             family reads, ``SHARED_INPUTS``, and those it adds): the
             largest gap over the largest value of the tensor; 1 where an
             index or a mask differs;
  fusion     the family's fusion layers' outputs (SHPL: the pooled features
             through kernel A, mixed): the widest relative L2 gap;
  rpn        the RPN's (a one-stage family's dense head's) last hidden
             features at the valid anchors (the AVOD family's FC over the
             fused crops of kernel C, the rcnn family's conv over the fused
             map): relative L2 gap;
  rpn_nms    the RPN picks' score gap (probability);
  proposals  the proposal boxes at the valid picks: largest gap (m);
  stage2     the stage-2 head's last hidden features at the valid proposals
             (its FC stack over both views' exact crops): relative L2 gap;
  final_nms  the final per-class picks' score gap (probability);
  boxes      the final boxes' largest gap of centre, height, and length and
             width as an unordered pair (m);
  heading    the final boxes' heading line: largest gap of ``ry`` modulo pi
             (rad);
  flip       the final boxes' heading side: the reference's flip-logit gap
             at the port's side (logit);
  scores     the final scores' largest gap (probability).

Which of them a family reads follows from its file's ``STAGES``
(``STAGE_NUMBERS``): two stages read all 11; one stage reads the 8 that are
not ``rpn_nms``, ``proposals`` or ``stage2``, which it does not have (they
are absent from its readings, not 0). A one-stage family's reference runs
whole, with no picks or proposals handed over, and decodes at the port's
final picks, which index its anchors; its heading's vector share is taken
against the median over the valid anchors.

``verdict`` holds readings against a cell's limits, for a run and for the
control alike. What differs by detector family (the layers read, the inputs
it adds) comes from the cell's family file (``families/<architecture>.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from reference import pipeline as ref_pl
from reference.config import AreaExtents
from reference.encoders import heading_flip_bit
from reference.nms import NmsResult

IOU_MARGIN = 0.05
HEADING_SHARE = 1.0
# the numbers a family reads, by its file's STAGES
STAGE_NUMBERS = {
    2: ("inputs", "fusion", "rpn", "rpn_nms", "proposals", "stage2", "final_nms", "boxes", "heading", "flip",
        "scores"),
    1: ("inputs", "fusion", "rpn", "final_nms", "boxes", "heading", "flip", "scores"),
}


def numbers(family) -> tuple:
    """The numbers the judge reads of ``family``, in order."""

    return STAGE_NUMBERS[family.STAGES]


def rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    scale = b.abs().max().item() if b.numel() else 0.0
    gap = (a - b).abs().max().item() if b.numel() else 0.0
    return gap / scale if scale > 0 else gap


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    den = torch.linalg.vector_norm(b).item()
    num = torch.linalg.vector_norm(a - b).item()
    return num / den if den > 0 else num


def _finite(x: float) -> float:
    return x if math.isfinite(x) else float("inf")


def pick_gap(boxes: torch.Tensor, scores: torch.Tensor, indices: torch.Tensor, valid: torch.Tensor,
             threshold: float) -> float:
    """Teacher-forced greedy NMS: the reference's boxes [B, N, 4] and
    scores [B, N] (-inf where invalid) against the port's picks [B, K].
    Each step reads the best live reference score less the pick's; a step
    the port leaves invalid while the reference still holds a candidate
    reads that candidate's score; a pick the reference had surely
    suppressed reads its own score."""

    b, n = scores.shape
    ar = torch.arange(b, device=scores.device)
    scores = scores.double()
    live = scores.clone()
    dead = torch.zeros((b, n), dtype=torch.bool, device=scores.device)
    y1, x1, y2, x2 = boxes.double().unbind(-1)
    areas = torch.clamp_min(y2 - y1, 0) * torch.clamp_min(x2 - x1, 0)
    worst = torch.zeros(b, dtype=torch.float64, device=scores.device)
    for i in range(indices.shape[1]):
        best = live.max(dim=1).values
        p, v = indices[:, i].long(), valid[:, i]
        sp = scores[ar, p]
        g_pick = torch.maximum(best - sp, torch.where(dead[ar, p], sp, torch.zeros_like(sp)))
        g_none = torch.where(best > -torch.inf, best, torch.zeros_like(best))
        g = torch.where(v, g_pick, g_none)
        worst = torch.maximum(worst, torch.nan_to_num(g, nan=torch.inf, neginf=0.0))
        py1, px1, py2, px2 = y1[ar, p][:, None], x1[ar, p][:, None], y2[ar, p][:, None], x2[ar, p][:, None]
        inter = torch.clamp_min(torch.minimum(py2, y2) - torch.maximum(py1, y1), 0) * (
            torch.clamp_min(torch.minimum(px2, x2) - torch.maximum(px1, x1), 0))
        union = areas[ar, p][:, None] + areas - inter
        iou = torch.where(union > 0, inter / torch.clamp_min(union, 1e-12), 0.0)
        out = v[:, None] & (iou > threshold - IOU_MARGIN)
        out[ar, p] |= v
        live = torch.where(out, -torch.inf, live)
        dead |= v[:, None] & (iou > threshold + IOU_MARGIN)
    return _finite(worst.max().item())


def feature_layers(model, family) -> Dict[str, str]:
    """The layers whose outputs feed the RPN's and stage 2's heads, by the
    module names that the port and the reference share (the family's, where
    the model has them)."""

    names = dict(model.named_modules())
    return {key: name for key, name in family.feature_layers(set(names)).items() if name in names}


def fusion_layers(model, family) -> Dict[str, str]:
    """The family's fusion layers that the model has, by name."""

    names = dict(model.named_modules())
    return {name: name for name in family.FUSION_LAYERS if name in names}


class LayerHooks:
    """Keeps the outputs of the layers ``{key: module name}`` in
    ``self.out``."""

    def __init__(self, model, layers: Dict[str, str]):
        self.out: Dict[str, torch.Tensor] = {}
        modules = dict(model.named_modules())
        for key, name in layers.items():
            modules[name].register_forward_hook(self._hook(key))

    def _hook(self, key):
        def hook(_module, _args, output):
            self.out[key] = output
        return hook


def box_gap(port: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest gap (m) of boxes [N, 7] (x, y, z, l, w, h, ry) in centre,
    height, and length and width as an unordered pair."""

    def shape(b):
        lw = torch.sort(b[:, 3:5], dim=-1).values
        return torch.cat([b[:, :3], b[:, 5:6], lw], dim=-1)

    return _finite((shape(port) - shape(ref)).abs().max().item())


def heading_gaps(port_boxes: torch.Tensor, ref_boxes: torch.Tensor, valid: torch.Tensor, out: Dict,
                 candidates: torch.Tensor, picks: torch.Tensor, from_vector: bool,
                 shares: Sequence[float]) -> Dict[str, float]:
    """The heading's line and side at the final detections: boxes [B, C, K,
    7], ``valid`` [B, C, K], the reference's ``out`` with its heads at each
    candidate the final NMS chose from (a two-stage family's proposals, a
    one-stage family's anchors), the candidates' validity [B, N] and the
    port's picks [B, C, K] into them. ``heading@<share>`` reads the line
    where the reference's orientation vector is at least ``share`` times its
    frame's median over the valid candidates (every detection where the line
    does not come from it)."""

    b, c, k = picks.shape
    flat = picks.reshape(b, c * k, 1).long()
    ry_p, ry_r = port_boxes[..., 6].double(), ref_boxes[..., 6].double()
    line = torch.abs(torch.remainder(ry_p - ry_r + math.pi / 2, math.pi) - math.pi / 2)
    if from_vector:
        vec = torch.linalg.vector_norm(out["orientation"].double(), dim=-1)
        med = torch.stack([torch.median(v[m]) if m.any() else v.new_tensor(0.0) for v, m in zip(vec, candidates)])
        ratio = torch.gather(vec, 1, flat[..., 0]).reshape(b, c, k) / torch.clamp_min(med, 1e-30)[:, None, None]
    res = {}
    for share in shares:
        keep = valid & (ratio >= share) if from_vector else valid
        res[f"heading@{share:g}"] = line[keep].max().item() if keep.any() else 0.0
    if "flip_logits" in out:
        logits = torch.gather(out["flip_logits"].double(), 1, flat.expand(-1, -1, 2)).reshape(b, c, k, 2)
        side = heading_flip_bit(ry_p)
        gap = logits.max(dim=-1).values - torch.gather(logits, -1, side[..., None])[..., 0]
        res["flip"] = gap[valid].max().item() if valid.any() else 0.0
    else:
        res["flip"] = 0.0
    return res


def verdict(readings: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: each limited number beside its limit, and
    whether every one is finite and within it."""

    checks = {name: {"value": float(readings[name]), "limit": float(limit)} for name, limit in limits.items()}
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values()), checks


def input_keys(family) -> tuple:
    """The model inputs recorded and compared: the shared ones the family
    reads, then its own."""

    return tuple(family.SHARED_INPUTS) + tuple(family.INPUTS)


def recorded_input(value):
    """An input as a record keeps it: a COO table (``rows``, ``cols``,
    ``vals``) as a dict of its tensors, anything else as it is."""

    if all(hasattr(value, k) for k in ("rows", "cols", "vals")):
        return {"rows": value.rows, "cols": value.cols, "vals": value.vals}
    return value


def inputs_gap(port: Dict, ref: Dict, keys: Sequence[str]) -> float:
    """1 where a flag, a mask, an index tensor or a COO table's indices
    differ, or a shape; else the largest of each float tensor's (and COO
    table's values') gap over its largest value."""

    gaps = [0.0]
    for key in keys:
        p, r = port[key], recorded_input(ref[key])
        if isinstance(r, dict):  # a COO table
            for k in ("rows", "cols"):
                if p[k].shape != r[k].shape or not torch.equal(p[k].cpu(), r[k].cpu()):
                    return 1.0
            gaps.append(rel_max(p["vals"], r["vals"]))
        elif not isinstance(r, torch.Tensor):
            if bool(p) != bool(r):
                return 1.0
        elif not r.is_floating_point():
            if not torch.equal(p.cpu(), r.cpu()):
                return 1.0
        else:
            if p.shape != r.shape:
                return 1.0
            gaps.append(rel_max(p, r))
    return _finite(max(gaps))


def fusion_gap(port: Dict, ref: Dict) -> float:
    """The widest relative L2 gap of the fusion layers' outputs; inf where
    the two sides hold different layers."""

    if set(port) != set(ref):
        return float("inf")
    return max((rel_l2(port[k], ref[k]) for k in ref), default=0.0)


def _bf16_rounded(value):
    """A float tensor, or a COO table's values, rounded through bfloat16;
    anything else as it is."""

    def r(t):
        return t.to(torch.bfloat16).to(t.dtype)
    if dataclasses.is_dataclass(value) and hasattr(value, "vals"):
        return dataclasses.replace(value, vals=r(value.vals))
    if isinstance(value, torch.Tensor) and value.is_floating_point():
        return r(value)
    return value


class Reference:
    """The float32 reference of a cell's configuration, with the run's
    weights; ``lower`` makes it the control (float8 layers, bfloat16 inputs)."""

    def __init__(self, cell, state: Dict[str, torch.Tensor], device, lower=None):
        config = cell.config
        self.cfg, self.family = cell.model_cfg, cell.family
        self.ext = AreaExtents(**config["extents"]) if "extents" in config else AreaExtents()
        self.device = device
        self.stages = self.family.STAGES
        self.model = ref_pl.make_model(self.cfg, self.ext, device, self.family)
        self.model.load_state_dict({k: v.float() for k, v in state.items()})
        self.lower = lower
        ref_pl.set_lower(self.model, lower)
        self.anchors = ref_pl.static_anchor_grid(self.cfg, self.ext, device, self.family)
        self.buckets = self.cfg.sparse_pool.buckets
        self.inputs = input_keys(self.family)
        self.features = LayerHooks(self.model, feature_layers(self.model, self.family))
        self.fused = LayerHooks(self.model, fusion_layers(self.model, self.family))

    @torch.no_grad()
    def run(self, frames: Sequence[Dict[str, np.ndarray]], rpn_picks=None, final_picks=None, proposals=None):
        """Inputs, model outputs and detections of one request; with picks
        and proposals, stage 2 and the decode follow them. A one-stage
        model takes neither ``rpn_picks`` nor ``proposals``."""

        batch = ref_pl.stack_frames(frames, self.buckets, self.device)
        keep = torch.ones((len(frames), 2), dtype=torch.float32, device=self.device)
        inputs = ref_pl.build_model_inputs_batch(batch, self.anchors, keep, self.cfg, self.ext, self.family)
        if self.lower is not None:  # the control computes its f32 stages in bf16
            inputs = dict(inputs, **{k: _bf16_rounded(inputs[k]) for k in self.inputs})
        out = self.model(inputs, picks=rpn_picks, proposals=proposals) if self.stages == 2 else self.model(inputs)
        out["features"], out["fused"] = dict(self.features.out), dict(self.fused.out)
        det = ref_pl.decode_batch(out, batch.ground_plane, self.cfg, self.ext, picks=final_picks,
                                  family=self.family)
        return inputs, out, det

    def record(self, request: int, ids: List[int], frames) -> Dict:
        """The control's record of one request, in the form the port's
        timed path leaves (``serve.Recorder``)."""

        inputs, out, det = self.run(frames)
        rec = {
            "request": request, "ids": list(ids),
            "inputs": {k: recorded_input(inputs[k]) for k in self.inputs},
            "fused": out["fused"],
            "features": out["features"],
            "out": {k: out[k] for k in OUT_KEYS if k in out},
            "final": [(p.indices, p.valid) for p in det["picks"]],
            "det": {k: det[k].cpu() for k in ("boxes_3d", "scores", "valid")},
        }
        if self.stages == 2:
            rec["rpn"] = (out["rpn_picks"].indices, out["rpn_picks"].valid)
        return rec


OUT_KEYS = ("objectness", "rpn_offsets", "anchor_valid", "proposals", "proposal_valid", "cls_logits",
            "box_offsets", "orientation", "flip_logits")


def to_device(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device) for v in x)
    return x


@torch.no_grad()
def judge(records: List[Dict], frames: Sequence[Dict[str, np.ndarray]], ref: Reference,
          heading_shares: Sequence[float] = ()) -> Dict[str, float]:
    """The widest reading of each number over ``records``; ``heading_shares``
    adds ``heading@<share>``, the heading's line read at other shares."""

    shares = [HEADING_SHARE] + [s for s in heading_shares if s != HEADING_SHARE]
    two = ref.stages == 2
    worst = dict.fromkeys(numbers(ref.family) + tuple(f"heading@{s:g}" for s in shares[1:]), 0.0)

    def take(name, value):
        worst[name] = max(worst[name], _finite(float(value)))

    for rec in records:
        rec = to_device(rec, ref.device)
        final_picks = [NmsResult(*p) for p in rec["final"]]
        frames_of = [frames[i] for i in rec["ids"]]
        if two:
            rpn_picks = NmsResult(*rec["rpn"])
            inputs, out, det = ref.run(frames_of, rpn_picks, final_picks, rec["out"]["proposals"].float())
        else:
            inputs, out, det = ref.run(frames_of, final_picks=final_picks)
        take("inputs", inputs_gap(rec["inputs"], inputs, ref.inputs))
        take("fusion", fusion_gap(rec["fused"], out["fused"]))
        po, pf, rf = rec["out"], rec["features"], out["features"]
        av = inputs["anchor_valid"]
        if pf["rpn"].shape != rf["rpn"].shape or ("objectness" in out and (
                "objectness" not in po or po["objectness"].shape != out["objectness"].shape)):
            take("rpn", float("inf"))
        else:  # the AVOD head's features are per anchor; the rcnn conv's per cell
            rpn_valid = av if rf["rpn"].dim() == 3 else slice(None)
            take("rpn", rel_l2(pf["rpn"][rpn_valid], rf["rpn"][rpn_valid]))
        if two:
            take("rpn_nms", pick_gap(out["prop_bev_all"], out["scores_all"], rpn_picks.indices,
                                     rpn_picks.valid, ref.cfg.rpn.nms_iou_thresh))
            pv = out["proposal_valid"]
            take("proposals", (po["proposals"][pv].double() - out["own_proposals"][pv].double()).abs().max().item()
                 if pv.any() else 0.0)
            take("stage2", rel_l2(pf["s2"][pv], rf["s2"][pv]) if pf["s2"].shape == rf["s2"].shape else float("inf"))
        for ci, p in enumerate(final_picks):
            take("final_nms", pick_gap(det["bev_all"], det["class_scores"][..., ci], p.indices, p.valid,
                                       ref.cfg.avod.nms_iou_thresh))
        pd = rec["det"]
        valid = pd["valid"]
        if not torch.equal(valid, det["valid"]):
            take("scores", 1.0)
        if valid.any():
            take("boxes", box_gap(pd["boxes_3d"][valid].double(), det["boxes_3d"][valid].double()))
            take("scores", (pd["scores"][valid].double() - det["scores"][valid].double()).abs().max().item())
        picks = torch.stack([p.indices for p in final_picks], dim=1)
        gaps = heading_gaps(pd["boxes_3d"], det["boxes_3d"], valid, out, out["proposal_valid"] if two else av,
                            picks, ref.cfg.avod.box_rep == "offsets", shares)
        gaps["heading"] = gaps.pop(f"heading@{HEADING_SHARE:g}")
        for name, value in gaps.items():
            take(name, value)
    return worst
