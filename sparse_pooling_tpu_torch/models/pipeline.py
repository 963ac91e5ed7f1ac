"""End-to-end pipeline: raw batch -> model outputs -> detections or losses.

Port of ``sparse_pooling_tpu.models.pipeline``: the voxelizer (packed
where the backbone packs, else the full raster) and the SHPL COO build of
the families that fuse by SHPL, the in-graph image resize and each
family's own inputs are made on the device;
``forward_batch_fn`` runs the detector (serving under ``no_grad``;
``train=True`` with path drop and dropout drawn from a ``torch.Generator``),
``decode_batch`` the final NMS and ``loss_batch`` the training losses.

What differs by ``cfg.architecture`` comes from one table, ``FAMILIES``:
the ``models.detector.Family`` each family module ends with (model, anchor
grid, a frame's anchors and own inputs, decode, check). The families: the
AVOD-style ``SparsePoolingDetector`` (``models.detector``), the MV3D-style
``FusionRcnn`` (``models.fusion_rcnn``), MV3D as published, ``Mv3d``
(``models.mv3d``, serving only), and ContFuse, ``ContFuse``
(``models.contfuse``, one stage, continuous fusion in place of SHPL, serving
only). Each family's ``frame_inputs`` builds the inputs it reads, the
SHPL families' through ``detector.shpl_inputs``. A new family is its
module, its configuration section and one entry here. Entry points take ``device``
(default ``"cuda"``) and raise when it is unavailable.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from sparse_pooling_tpu_torch import resolve_device
from sparse_pooling_tpu_torch.configs.config import AreaExtents, ModelConfig
from sparse_pooling_tpu_torch.models import contfuse, detector, draws, fusion_rcnn, mv3d
from sparse_pooling_tpu_torch.models.detector import Family
from sparse_pooling_tpu_torch.models.loss import detector_loss_batch
from sparse_pooling_tpu_torch.ops.image_resize import resize_bilinear_batch
from sparse_pooling_tpu_torch.runtime.graphs import GraphedCall
from sparse_pooling_tpu_torch.runtime.profiling import span


class RawSample(NamedTuple):
    """Per-batch device inputs (leading batch dim on every field)."""

    points: torch.Tensor  # [B, P, 3] f32 camera frame, zero-padded ([B, P, 4] with intensity: mv3d)
    points_mask: torch.Tensor  # [B, P] bool
    image: torch.Tensor  # [B, Hi, Wi, 3] uint8 canvas
    p2: torch.Tensor  # [B, 3, 4] f32 canvas-scaled
    ground_plane: torch.Tensor  # [B, 4] f32
    gt_boxes_3d: torch.Tensor  # [B, G, 7] f32 padded
    gt_valid: torch.Tensor  # [B, G] bool
    gt_classes: torch.Tensor  # [B, G] int32
    image_scale: Any = None  # [B, 2] f32 (sy, sx) = canvas / raw, or None


# architecture -> its family: the one place the port names them
FAMILIES = {"avod": detector.FAMILY, "rcnn": fusion_rcnn.FAMILY, "mv3d": mv3d.FAMILY, "contfuse": contfuse.FAMILY}


def family(cfg: ModelConfig) -> Family:
    """The family of ``cfg.architecture``; raises for an unknown one."""

    if cfg.architecture not in FAMILIES:
        raise ValueError(f"unknown architecture '{cfg.architecture}'")
    return FAMILIES[cfg.architecture]


# fields and bytes ``stack_frames`` staged since import: pinned (a card) or plain
_UPLOADS = {"pinned_fields": 0, "pinned_bytes": 0, "plain_fields": 0, "plain_bytes": 0}
# the image first: the largest field's copy runs while the host stacks the rest
_UPLOAD_ORDER = ("image",) + tuple(n for n in RawSample._fields if n != "image")


def upload_counts() -> Dict[str, int]:
    """The fields and bytes ``stack_frames`` has staged in this process,
    pinned (``pinned_fields``, ``pinned_bytes``) or plain (``plain_*``)."""

    return dict(_UPLOADS)


def stack_frames(frames: Sequence[Dict[str, np.ndarray]], device="cuda") -> RawSample:
    """Stack per-frame numpy dicts (``data.synthetic_frame``) into a batched
    ``RawSample`` on ``device``.

    Each field is stacked in one host pass into a fresh staging tensor. For
    a card it is page-locked and copied without a wait: the result is ready
    in the current stream's order, and PyTorch's caching host allocator
    hands the block out again only once that copy has finished. Off a card
    the staging tensor is the result."""

    dev = resolve_device(device)
    pin = dev.type == "cuda"
    kind = "pinned" if pin else "plain"
    fields = {}
    with span("upload"):
        for name in _UPLOAD_ORDER:
            arrs = [f.get(name) for f in frames]
            if arrs[0] is None:
                fields[name] = None
                continue
            dtype = torch.from_numpy(np.empty(0, np.result_type(*arrs))).dtype
            staging = torch.empty((len(arrs),) + arrs[0].shape, dtype=dtype, pin_memory=pin)
            np.stack(arrs, out=staging.numpy())
            fields[name] = staging.to(dev, non_blocking=pin)
            _UPLOADS[kind + "_fields"] += 1
            _UPLOADS[kind + "_bytes"] += staging.nbytes
    return RawSample(**fields)


def static_anchor_grid(cfg: ModelConfig, extents: AreaExtents, device="cuda") -> torch.Tensor:
    """The family's anchor grid constant [N, 8] f32 with y = 0 (filled per
    frame) on ``device``."""

    return torch.from_numpy(family(cfg).anchor_grid(cfg, extents)).to(resolve_device(device))


def anchors_with_ground_y(anchors_static: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """Per-frame anchors [B, N, 8] with y on each frame's ground plane [B, 4]."""

    a, b, c, d = (plane[:, i : i + 1] for i in range(4))
    x, z = anchors_static[None, :, 0], anchors_static[None, :, 2]
    y = -(a * x + c * z + d) / b
    out = anchors_static[None].repeat(plane.shape[0], 1, 1)
    out[..., 1] = y
    return out


def make_model(cfg: ModelConfig, extents: AreaExtents = AreaExtents(), device="cuda"):
    """Build the detector of ``cfg.architecture`` (its family's model) on
    ``device`` in eval mode (parameters from PyTorch's
    default init; load ``weights.from_flax`` or ``weights.init_like_flax``
    before use)."""

    dev = resolve_device(device)
    expected_stride = 2 ** (len(cfg.backbone.channels) - 1)
    if cfg.sparse_pool.fusion_stride != expected_stride:
        raise ValueError(
            "sparse_pool.fusion_stride must equal the encoder's final stride "
            f"2^(stages-1) = {expected_stride}, got {cfg.sparse_pool.fusion_stride}"
        )
    bh, bw = cfg.bev.padded_hw(extents)
    s = cfg.sparse_pool.fusion_stride
    for name, (h, w) in {"bev": (bh, bw), "image": (cfg.image.height, cfg.image.width)}.items():
        if h % s or w % s:
            raise ValueError(f"{name} lattice {h}x{w} not divisible by stride {s}")
    ds = cfg.backbone.decode_stride
    if ds < 1 or (ds & (ds - 1)):
        raise ValueError(f"backbone.decode_stride must be a power of 2, got {ds}")
    if ds >= cfg.sparse_pool.fusion_stride:
        raise ValueError(
            f"backbone.decode_stride {ds} must be below the encoder's final "
            f"stride {cfg.sparse_pool.fusion_stride}"
        )
    for name, st in (("bev_roi_stride", cfg.rpn.bev_roi_stride), ("img_roi_stride", cfg.rpn.img_roi_stride)):
        if st % ds:
            raise ValueError(
                f"rpn.{name}={st} must be a multiple of backbone.decode_stride={ds}"
            )
    if cfg.rpn.roi_channels and ((cfg.rpn.bev_roi_stride > 1) != (cfg.rpn.img_roi_stride > 1)):
        raise ValueError(
            f"rpn.roi_channels projects the strided view to {cfg.rpn.roi_channels} channels; "
            "with only one view strided the RPN mean-fuse would mix mismatched widths — "
            "stride both views, neither, or set roi_channels=0"
        )
    if cfg.anchors.max_anchors % (len(cfg.anchors.sizes) * len(cfg.anchors.rotations)):
        raise ValueError(
            f"anchors.max_anchors={cfg.anchors.max_anchors} must be divisible "
            "by the class x rotation variant count"
        )
    fam = family(cfg)
    fam.check(cfg)
    return fam.model(cfg, extents).to(dev).eval()


# the fields of a RawSample the input build reads, image_scale aside
_BUILD_FIELDS = ("points", "points_mask", "ground_plane", "p2", "image")
# input signature -> its graphs.GraphedCall
_INPUT_GRAPHS: Dict[tuple, GraphedCall] = {}
_INPUT_GRAPHS_LOCK = threading.Lock()
_INPUT_GRAPH_COUNTS = {"captures": 0, "replays": 0, "eager": 0}


def input_graph_counts() -> Dict[str, int]:
    """The calls of ``build_model_inputs_batch`` in this process: those
    that captured their signature's graphs (``captures``), replayed them
    (``replays``, a capturing call included) or built eagerly (``eager``)."""

    with _INPUT_GRAPHS_LOCK:
        return dict(_INPUT_GRAPH_COUNTS)


def _count(name: str) -> None:
    with _INPUT_GRAPHS_LOCK:
        _INPUT_GRAPH_COUNTS[name] += 1


def _build_tensors(batch: RawSample, anchors_static: torch.Tensor, path_keep: torch.Tensor):
    return [getattr(batch, n) for n in _BUILD_FIELDS] + (
        [batch.image_scale] if batch.image_scale is not None else []) + [anchors_static, path_keep]


def input_signature(batch: RawSample, anchors_static: torch.Tensor, path_keep: torch.Tensor,
                    cfg: ModelConfig, extents: AreaExtents) -> tuple:
    """Everything that changes the input build's device work: the device,
    each tensor it reads (shape, dtype, strides; whether ``image_scale`` is
    there), the configuration and the extents; and whether inference mode
    is on, which makes the tensors it writes inference tensors."""

    tensors = _build_tensors(batch, anchors_static, path_keep)
    return (batch.points.device, batch.image_scale is not None, torch.is_inference_mode_enabled(),
            tuple((t.shape, t.dtype, t.stride()) for t in tensors), cfg, extents)


def _graphs_apply(tensors, cfg: ModelConfig) -> bool:
    """Whether the input build of ``tensors`` (``_build_tensors``) replays
    graphs: on a card, autograd off, neither compiled nor traced (an
    export's fake tensors are a subclass), a family whose ``frame_inputs``
    wait on nothing on the host."""

    return (tensors[0].is_cuda and not torch.is_grad_enabled() and family(cfg).frame_inputs_wait_free
            and all(type(t) is torch.Tensor for t in tensors) and not torch.compiler.is_compiling())


def build_model_inputs_batch(
    batch: RawSample,
    anchors_static: torch.Tensor,
    path_keep: torch.Tensor,  # [B, 2]
    cfg: ModelConfig,
    extents: AreaExtents,
) -> Dict[str, Any]:
    """Batch-native input construction on the batch's device: the shared
    inputs and the family's (``Family.frame_inputs``).

    Where ``_graphs_apply``, the first call of each ``input_signature``
    captures the build as CUDA graphs and every call replays them
    (``runtime/graphs.GraphedCall``: the same kernels, so the same bits, and
    tensors the caller owns); a call that finds its signature's graphs busy
    on another thread builds eagerly, as every other call does."""

    with span("inputs"):
        tensors = _build_tensors(batch, anchors_static, path_keep)
        if _graphs_apply(tensors, cfg):
            key = input_signature(batch, anchors_static, path_keep, cfg, extents)
            with _INPUT_GRAPHS_LOCK:
                graph = _INPUT_GRAPHS.get(key)
                if graph is None:
                    scaled = batch.image_scale is not None

                    def build(*args):  # the captured tensors, in _build_tensors' order
                        fields = dict(zip(_BUILD_FIELDS, args))
                        sample = RawSample(**fields, gt_boxes_3d=None, gt_valid=None, gt_classes=None,
                                           image_scale=args[len(_BUILD_FIELDS)] if scaled else None)
                        return _build_inputs(sample, args[-2], args[-1], cfg, extents)

                    graph = _INPUT_GRAPHS[key] = GraphedCall(build)
            if graph.lock.acquire(blocking=False):
                try:
                    if not graph.captured:
                        _count("captures")
                    out = graph(tensors)
                finally:
                    graph.lock.release()
                _count("replays")
                return out
        _count("eager")
        return _build_inputs(batch, anchors_static, path_keep, cfg, extents)


def _build_inputs(batch: RawSample, anchors_static: torch.Tensor, path_keep: torch.Tensor, cfg: ModelConfig,
                  extents: AreaExtents) -> Dict[str, Any]:
    """The input build's device work: the image, and the inputs the
    family reads (``Family.frame_inputs``)."""

    if cfg.image.device_resize and batch.image_scale is not None:
        image = resize_bilinear_batch(batch.image, batch.image_scale)
    else:
        image = batch.image.to(torch.float32) / 255.0
    frame = family(cfg).frame_inputs(batch, anchors_with_ground_y(anchors_static, batch.ground_plane), cfg, extents)
    return {"image": image, **frame, "p2": batch.p2, "path_keep": path_keep}


def sample_path_keep(generator: Optional[torch.Generator], cfg: ModelConfig,
                     batch_size: Optional[int] = None, device=None) -> torch.Tensor:
    """Path-drop flags: keep each branch with its configured probability,
    but never drop both (a third draw revives one). [2] f32, or [B, 2] with
    ``batch_size``; drawn on ``device`` (default the generator's), at the
    global batch's shape for a ``draws.BatchRows``."""

    n = 1 if batch_size is None else batch_size
    dev = device if device is not None else (generator.device if generator is not None else "cpu")
    if not cfg.path_drop.enabled:
        keep = torch.ones((n, 2), dtype=torch.float32, device=dev)
    else:
        u = draws.rand((n, 3), generator, dev)
        bev = u[:, 0] < cfg.path_drop.bev_keep_prob
        img = u[:, 1] < cfg.path_drop.img_keep_prob
        neither = ~(bev | img)
        revive_bev = u[:, 2] < 0.5
        bev = bev | (neither & revive_bev)
        img = img | (neither & ~revive_bev)
        keep = torch.stack([bev, img], dim=-1).to(torch.float32)
    return keep[0] if batch_size is None else keep


def forward_batch_fn(
    model,
    batch: RawSample,
    anchors_static: torch.Tensor,
    cfg: ModelConfig,
    extents: AreaExtents,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Batched end-to-end forward: raw inputs -> model outputs. Serving
    (``train=False``) runs under ``no_grad`` with both branches kept;
    training draws path drop, then dropout, from ``generator`` (on the
    batch's device) and keeps the graph for the backward."""

    b, dev = batch.points.shape[0], batch.points.device
    with contextlib.nullcontext() if train else torch.no_grad():
        if train:
            path_keep = sample_path_keep(generator, cfg, batch_size=b, device=dev)
        else:
            path_keep = torch.ones((b, 2), dtype=torch.float32, device=dev)
        inputs = build_model_inputs_batch(batch, anchors_static, path_keep, cfg, extents)
        return model(inputs, train=train, generator=generator)


def loss_batch(outputs, batch: RawSample, cfg: ModelConfig, extents: AreaExtents,
               generator: Optional[torch.Generator] = None, noise=None) -> Dict[str, torch.Tensor]:
    """Training losses of a batch, either family (``models.loss.detector_loss_batch``);
    the sampling noise comes from ``generator`` unless ``noise`` is given."""

    return detector_loss_batch(
        outputs, batch.gt_boxes_3d, batch.gt_valid, batch.gt_classes, batch.ground_plane,
        cfg, extents, generator=generator, noise=noise,
    )


@torch.no_grad()
def decode_batch(outputs, ground_plane: torch.Tensor, cfg: ModelConfig, extents: AreaExtents):
    """Final detections: boxes_3d [B, C, K, 7], scores [B, C, K], valid."""

    with span("decode"):
        return family(cfg).decode(outputs, ground_plane, cfg, extents)
