"""Greedy NMS as the operator ``torch.ops.spt.greedy_nms`` (``ops/nms.py``,
``csrc/greedy_nms.cu``).

On the CPU: ``nms_batch`` calls the operator, whose CPU kernel is the plain
loop ``nms_batch_plain`` (held against the JAX package in
``tests/test_torch_ops.py``); the fake kernel gives its shapes; ``torch.export``
records one call; the launcher refuses CPU tensors.

On the card (marker ``cuda``): the kernel against the plain loop, indices and
validity equal bit for bit, at N = 1, 37, 300, 4096 and 17600 (the rcnn
dense grid, the largest any preset passes), ``max_outputs`` below and above
the valid count, thresholds 0.01, 0.5 and 0.8, over random, tied, masked and
degenerate inputs (every call site passes float32 boxes); one launch a call;
two a request of a thin rcnn model, each inside its NMS span. No JAX here:
``python3 -m pytest --noconftest -m cuda tests/test_torch_nms_kernel.py``.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sparse_pooling_tpu_torch.ops import nms

N_LARGEST = 17600  # rcnn_cars: its dense grid of 8800 cells x 2 rotations, every anchor a candidate


class _Calls(TorchDispatchMode):
    """Records the operators called at the top level (not inside others)."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _case(b, n, kind, seed):
    """Boxes [b, n, 4] f32 packed so that about a third overlap a neighbour
    above IoU 0.5; scores [b, n] f32 of the kind."""

    rng = np.random.RandomState(seed)
    side = max(np.sqrt(n) * 1.5, 2.0)
    c = rng.uniform(0, side, (b, n, 2))
    half = rng.uniform(0.3, 1.5, (b, n, 2))
    boxes = np.concatenate([c - half, c + half], -1).astype(np.float32)
    scores = rng.rand(b, n).astype(np.float32)
    if kind == "ties":  # four score levels: ties broken by the lower index
        scores = np.floor(scores * 4).astype(np.float32) / 4
    elif kind == "masked":  # frame 0 all -inf, frame 1 mostly, frame 2 in part
        scores[0] = -np.inf
        scores[1 % b, rng.rand(n) < 0.95] = -np.inf
        scores[2 % b, rng.rand(n) < 0.3] = -np.inf
    elif kind == "degenerate":  # zero-area and identical boxes, +0 and -0 scores, +inf
        boxes[:, ::3] = boxes[:, :1]
        boxes[:, 1::5, 2] = boxes[:, 1::5, 0]
        boxes[:, 2::7] = boxes[:, 2::7][..., [2, 3, 0, 1]]
        scores[:, ::4] = -0.0
        scores[:, 1::4] = 0.0
        scores[:, 2::11] = np.inf
    elif kind == "nan":  # a NaN score wins argmax (invalid); NaN coordinates suppress nothing
        scores[0, n // 2] = np.nan
        boxes[1 % b, ::4, 1] = np.nan
    return torch.from_numpy(boxes), torch.from_numpy(scores)


def test_nms_batch_calls_the_operator_once():
    boxes, scores = _case(2, 50, "ties", 0)
    with _Calls() as calls:
        got = nms.nms_batch(boxes, scores, 20, 0.5)
    assert calls.names.count("spt.greedy_nms.default") == 1
    assert not any("argmax" in name for name in calls.names)
    want = nms.nms_batch_plain(boxes, scores, 20, 0.5)
    assert torch.equal(got.indices, want.indices) and torch.equal(got.valid, want.valid)
    with _Calls() as calls:
        nms.top_k_nms_batch(boxes, scores, 10, 0.5, pre_top_k=30)
    assert calls.names.count("spt.greedy_nms.default") == 1


def test_fake_kernel_gives_shapes_and_dtypes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        idx, valid = torch.ops.spt.greedy_nms(torch.empty(3, 4096, 4), torch.empty(3, 4096), 300, 0.8)
    assert idx.shape == valid.shape == (3, 300)
    assert idx.dtype == torch.int64 and valid.dtype == torch.bool


def test_export_records_one_operator_call():
    class Nms(torch.nn.Module):
        def forward(self, boxes, scores):
            return tuple(nms.top_k_nms_batch(boxes, scores, 12, 0.5, pre_top_k=40))

    boxes, scores = _case(2, 60, "masked", 1)
    ep = torch.export.export(Nms(), (boxes, scores))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("spt.greedy_nms.default") == 1
    assert not any("argmax" in t for t in targets)
    for got, want in zip(ep.module()(boxes, scores), Nms()(boxes, scores)):
        assert torch.equal(got, want)


def test_launcher_refuses_cpu_tensors_and_cpu_launches_nothing():
    boxes, scores = _case(2, 10, "random", 2)
    before = nms.greedy_nms_kernel.launches
    nms.nms_batch(boxes, scores, 4)
    assert nms.greedy_nms_kernel.launches == before
    with pytest.raises(ValueError, match="expected cuda"):
        nms.greedy_nms_kernel(boxes, scores, 4, 0.5)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _held(boxes, scores, k, thr, cuda):
    """The kernel's picks against the plain loop's on the CPU and on the card."""

    got_idx, got_valid = nms.greedy_nms_kernel(boxes.to(cuda), scores.to(cuda), k, thr)
    torch.cuda.synchronize()
    for dev in ("cpu", cuda):
        want = nms.nms_batch_plain(boxes.to(dev), scores.to(dev), k, thr)
        assert torch.equal(got_idx.cpu(), want.indices.cpu()), (dev, k, thr)
        assert torch.equal(got_valid.cpu(), want.valid.cpu()), (dev, k, thr)
    return got_valid


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 300, 4096, N_LARGEST])
@pytest.mark.parametrize("kind", ["random", "ties", "masked", "degenerate", "nan"])
@pytest.mark.parametrize("thr", [0.01, 0.5, 0.8])
def test_kernel_matches_plain_on_card(cuda, n, kind, thr):
    """max_outputs below the valid count (an eighth of the live candidates),
    then above it: at most 120 live a frame and 20 rounds more, the rest
    (index, False) as the plain loop emits them."""

    boxes, scores = _case(3, n, kind, seed=n + len(kind))
    live = int((scores > -np.inf).sum(1).max())
    valid = _held(boxes, scores, max(1, min(live // 8, 300)), thr, cuda)
    if n > 1:
        assert valid[2, -1]
    scores[:, 120:] = -np.inf
    valid = _held(boxes, scores, min(n, 120) + 20, thr, cuda)
    assert not valid[:, -1].any()


@pytest.mark.cuda
def test_kernel_edges_on_card(cuda):
    boxes, scores = _case(2, 64, "random", 3)
    flat = torch.cat([torch.zeros(1), boxes.reshape(-1)]).to(cuda)
    shifted = flat[1:].view(2, 64, 4)  # 4 bytes past a 16-byte boundary
    assert shifted.data_ptr() % 16 == 4
    got = nms.greedy_nms_kernel(shifted, scores.to(cuda), 30, 0.5)
    want = nms.nms_batch_plain(boxes, scores, 30, 0.5)
    assert torch.equal(got[0].cpu(), want.indices) and torch.equal(got[1].cpu(), want.valid)
    # no frame or no output: the operator answers without a launch, and the
    # launcher refuses to count one
    for b, k in ((0, 5), (2, 0)):
        before = nms.greedy_nms_kernel.launches
        idx, valid = nms.nms_batch(boxes[:b].to(cuda), scores[:b].to(cuda), k, 0.5)
        assert nms.greedy_nms_kernel.launches == before
        assert idx.shape == valid.shape == (b, k) and idx.is_cuda and valid.is_cuda
        with pytest.raises(ValueError, match="must be >= 1"):
            nms.greedy_nms_kernel(boxes[:b].to(cuda), scores[:b].to(cuda), k, 0.5)
        assert nms.greedy_nms_kernel.launches == before
    with pytest.raises(TypeError, match="float32"):
        nms.greedy_nms_kernel(boxes.to(cuda, torch.bfloat16), scores.to(cuda), 5, 0.5)
    big = torch.zeros(1, nms.max_candidates() + 1, 4, device=cuda)
    with pytest.raises(ValueError, match="candidates"):
        nms.greedy_nms_kernel(big, torch.zeros(big.shape[:2], device=cuda), 5, 0.5)
    # the largest N the kernel takes, boxes read from L2 each round
    n = nms.max_candidates()
    boxes, scores = _case(1, n, "random", 4)
    _held(boxes, scores, 40, 0.5, cuda)
    # N = 12288 and 12161: the keys alone fit in 48 KB, with the static slots
    # they do not. The first launch of a fresh process, so no larger N has
    # opened the kernel's shared memory before.
    script = """
import torch
from sparse_pooling_tpu_torch.ops import nms
for n in (12288, 12161):
    g = torch.Generator().manual_seed(n)
    c = torch.rand(2, n, 2, generator=g) * 160
    half = 0.3 + torch.rand(2, n, 2, generator=g) * 1.2
    boxes, scores = torch.cat([c - half, c + half], -1), torch.rand(2, n, generator=g)
    idx, valid = nms.greedy_nms_kernel(boxes.cuda(), scores.cuda(), 40, 0.5)
    want = nms.nms_batch_plain(boxes, scores, 40, 0.5)
    assert torch.equal(idx.cpu(), want.indices) and torch.equal(valid.cpu(), want.valid), n
"""
    root = pathlib.Path(__file__).resolve().parent.parent
    run = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(root)})
    assert run.returncode == 0, run.stderr[-2000:]


@pytest.mark.cuda
def test_nms_batch_launches_the_kernel_once_a_call(cuda):
    boxes, scores = (t.to(cuda) for t in _case(8, 4096, "random", 5))
    before = nms.greedy_nms_kernel.launches
    res = nms.nms_batch(boxes, scores, 300, 0.8)
    assert nms.greedy_nms_kernel.launches - before == 1
    res_k = nms.top_k_nms_batch(boxes, scores, 300, 0.8, pre_top_k=2048)
    assert nms.greedy_nms_kernel.launches - before == 2
    assert res.indices.is_cuda and res_k.valid.is_cuda


@pytest.mark.cuda
def test_rcnn_request_launches_nms_twice_inside_its_spans(cuda):
    """A thin rcnn model's request: one RPN and one final (one class) NMS
    launch, each made inside ``detector.rpn_nms`` or ``decode.nms``, and in
    a ``torch.profiler`` trace the operator calls inside those ranges."""

    from torch.profiler import ProfilerActivity, profile

    from sparse_pooling_tpu_torch.configs import AreaExtents
    from sparse_pooling_tpu_torch.configs.presets import rcnn_cars_config
    from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame
    from sparse_pooling_tpu_torch.models import pipeline as pl
    from sparse_pooling_tpu_torch.runtime import profiling

    cfg = rcnn_cars_config().model
    r = dataclasses.replace
    cfg = r(cfg, backbone=r(cfg.backbone, channels=(8, 8, 8, 16), out_channels=8),
            avod=r(cfg.avod, fc_layers=(64,)), rpn=r(cfg.rpn, fusion_channels=16))
    model = pl.make_model(cfg, device=cuda)
    anchors = pl.static_anchor_grid(cfg, AreaExtents(), device=cuda)
    batch = pl.stack_frames([synthetic_frame(cfg, 4096, s, image="noise") for s in range(2)], device=cuda)
    spans = []
    inner = nms.greedy_nms_kernel

    def launcher(*args):
        spans.append(profiling._active.stack[-1].name)
        return inner(*args)

    launcher.launches = 0
    nms.greedy_nms_kernel = launcher
    try:
        with torch.no_grad(), profiling.collect(cuda) as col:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                pl.decode_batch(pl.forward_batch_fn(model, batch, anchors, cfg, AreaExtents()),
                                batch.ground_plane, cfg, AreaExtents())
            torch.cuda.synchronize()
    finally:
        nms.greedy_nms_kernel = inner
    assert spans == ["detector.rpn_nms", "decode.nms"]
    got = col.summary()["spans"]
    assert all(got[name]["device_ms"][0] > 0 for name in spans)
    host = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    ranges = [e.time_range for e in host if e.name in ("spt.detector.rpn_nms", "spt.decode.nms")]
    calls = [e.time_range for e in host if e.name == "spt::greedy_nms"]
    assert len(ranges) == len(calls) == 2
    for call in calls:
        assert any(rg.start <= call.start and call.end <= rg.end for rg in ranges)
    device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("greedy_nms" in name for name in device) == 2
