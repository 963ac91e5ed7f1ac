"""Serving export: the batch forward and decode as one saved program.

Port of ``sparse_pooling_tpu.runtime.export``. The JAX package lowers the
jitted forward + decode to StableHLO with the weights baked in; the port
exports one ``nn.Module`` (``ServingModule``: ``pipeline.forward_batch_fn``
then ``pipeline.decode_batch``, holding the serving model's weights in their
serving dtype and the static anchor grid) with ``torch.export``, and saves
the ``ExportedProgram`` to one ``.pt2`` file. A later process calls it on a
``RawSample`` with no model code, config parsing or checkpoint:

    ep = export_inference(cfg, model, batch_size=8)        # trace
    save_exported(ep, "cars_b8.pt2")
    ...
    fn = load_serving_fn("cars_b8.pt2")                    # any process
    dets = fn(raw_batch)        # dict: boxes_3d, scores, valid

CLI: ``python -m sparse_pooling_tpu_torch.experiments.export_model``.

The graph calls the port's hand kernels as the operators
``torch.ops.spt.*`` (``kernels.OPS``), opaque to the tracer, whose fake
implementations give their shapes. So the artifact needs the port's kernels
(``csrc/`` and the operator registrations in ``ops/``), not its model code:
``load_serving_fn`` imports those registrations itself. As jax.export
records its platforms, the artifact records the device type it was
exported for, and the callable raises for a batch on another device. Every
shape is static (the batch size included), and the config's constants
(``models.detector.px_scales``, the NMS sizes) are fixed at export. TF32 and
cuDNN flags are process state, not part of the artifact.
"""

from __future__ import annotations

import json
from typing import Dict

import torch

from sparse_pooling_tpu_torch.configs.config import AreaExtents, PipelineConfig
from sparse_pooling_tpu_torch.data.dataset import MAX_GT_BOXES
from sparse_pooling_tpu_torch.models import pipeline as pl
from sparse_pooling_tpu_torch.ops import crop_resize, ell_sparse_pool, nms, sparse_pool  # noqa: F401 (torch.ops.spt)

DEVICE_FILE = "spt_device"  # the extra file of a saved artifact naming its device type


class ServingModule(torch.nn.Module):
    """The serving pipeline of one batch: ``RawSample`` fields (positional,
    in order) -> the detection dict of ``pipeline.decode_batch``."""

    def __init__(self, cfg: PipelineConfig, model: torch.nn.Module, anchors_static: torch.Tensor,
                 extents: AreaExtents):
        super().__init__()
        self.model = model
        self.register_buffer("anchors_static", anchors_static)
        self.model_cfg, self.extents = cfg.model, extents

    def forward(self, *fields: torch.Tensor) -> Dict[str, torch.Tensor]:
        batch = pl.RawSample(*fields)
        out = pl.forward_batch_fn(self.model, batch, self.anchors_static, self.model_cfg, self.extents)
        return pl.decode_batch(out, batch.ground_plane, self.model_cfg, self.extents)


def serving_input_spec(cfg: PipelineConfig, batch_size: int,
                       extents: AreaExtents = AreaExtents()) -> pl.RawSample:
    """The layout of one inference batch: a ``RawSample`` of meta tensors
    (shape and dtype; the gt fields are unused by the forward pass but part
    of the layout)."""

    m = cfg.model
    p = m.sparse_pool.max_points
    h, w = m.image.height, m.image.width
    g = MAX_GT_BOXES

    def s(shape, dtype):
        return torch.empty((batch_size,) + shape, dtype=dtype, device="meta")

    return pl.RawSample(
        points=s((p, 3), torch.float32),
        points_mask=s((p,), torch.bool),
        image=s((h, w, 3), torch.uint8),
        p2=s((3, 4), torch.float32),
        ground_plane=s((4,), torch.float32),
        gt_boxes_3d=s((g, 7), torch.float32),
        gt_valid=s((g,), torch.bool),
        gt_classes=s((g,), torch.int32),
        image_scale=s((2,), torch.float32),
    )


def export_inference(cfg: PipelineConfig, model: torch.nn.Module, batch_size: int = 8,
                     extents: AreaExtents = AreaExtents(), device=None) -> torch.export.ExportedProgram:
    """Trace the whole inference pipeline (build inputs -> the detector ->
    decode + NMS) for ``batch_size`` frames on ``device`` (default: the
    model's), with ``model``'s weights (the serving model of
    ``pipeline.make_model``, its weights loaded) and the anchor grid held in
    the program."""

    device = torch.device(device) if device is not None else next(model.parameters()).device
    model = model.to(device).eval()
    anchors = pl.static_anchor_grid(cfg.model, extents, device=device)
    example = tuple(torch.zeros(s.shape, dtype=s.dtype, device=device)
                    for s in serving_input_spec(cfg, batch_size, extents))
    return torch.export.export(ServingModule(cfg, model, anchors, extents), example, strict=False)


def _device_type(ep: torch.export.ExportedProgram) -> str:
    """The device type of the program's weights and buffers."""

    types = {t.device.type for t in ep.state_dict.values()}
    if len(types) != 1:
        raise ValueError(f"exported program's weights on {sorted(types)}, expected one device type")
    return types.pop()


def save_exported(ep: torch.export.ExportedProgram, path: str) -> int:
    """``torch.export.save`` to one file, with the device type it runs on;
    returns the file's byte count."""

    torch.export.save(ep, path, extra_files={DEVICE_FILE: json.dumps({"device": _device_type(ep)})})
    with open(path, "rb") as f:
        return len(f.read())


def load_exported(path: str):
    """-> (the ``ExportedProgram``, the device type it was exported for).
    The operators it calls are registered by this module's imports."""

    extra = {DEVICE_FILE: ""}
    ep = torch.export.load(path, extra_files=extra)
    return ep, json.loads(extra[DEVICE_FILE])["device"]


def load_serving_fn(path: str):
    """Load an artifact; returns a callable(raw_batch: ``RawSample``) ->
    detection dict. It raises for a batch on another device type than the
    artifact's."""

    ep, device_type = load_exported(path)
    module = ep.module()

    def fn(batch: pl.RawSample) -> Dict[str, torch.Tensor]:
        if batch.points.device.type != device_type:
            raise ValueError(f"artifact exported for {device_type}, batch on {batch.points.device}")
        return module(*batch)

    fn.exported, fn.device_type = ep, device_type
    return fn
