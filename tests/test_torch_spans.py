"""The port's spans (``runtime/profiling.py``): off, they are one shared
no-op; on, they record the serving path's span tree, request by
request, without changing a bit of its outputs, and show in a
``torch.profiler`` trace as ``spt.<name>`` ranges."""

import dataclasses
import time

import pytest
import torch

from sparse_pooling_tpu_torch import weights
from sparse_pooling_tpu_torch.configs import AreaExtents
from sparse_pooling_tpu_torch.configs.presets import unittest_config
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame
from sparse_pooling_tpu_torch.models import pipeline as pl
from sparse_pooling_tpu_torch.runtime import profiling

CPU = torch.device("cpu")
# span -> its parent, on the serving path of either family
TREE = {"upload": None, "inputs": None, "detector": None, "detector.encode": "detector",
        "detector.fusion": "detector", "detector.rpn_nms": "detector", "detector.decode_maps": "detector",
        "detector.stage2": "detector", "decode": None, "decode.nms": "decode"}
NMS_SPANS = ("detector.rpn_nms", "decode.nms")


def tiny(architecture):
    cfg = unittest_config().model
    if architecture == "rcnn":
        cfg = dataclasses.replace(cfg, architecture="rcnn",
                                  avod=dataclasses.replace(cfg.avod, box_rep="offsets"))
    return cfg


@pytest.fixture(scope="module", params=["avod", "rcnn"])
def server(request):
    """A tiny model of the family, its anchors and two batches of frames."""

    cfg, ext = tiny(request.param), AreaExtents()
    model = pl.make_model(cfg, ext, device=CPU)
    weights.init_like_flax(model, seed=0)
    anchors = pl.static_anchor_grid(cfg, ext, device=CPU)
    batches = [[synthetic_frame(cfg, 600, seed) for seed in (2 * r, 2 * r + 1)] for r in range(2)]
    return cfg, ext, model, anchors, batches


def serve(server, frames):
    """One request as the serving path runs it: upload, input build, the
    detector, the decode."""

    cfg, ext, model, anchors, _ = server
    batch = pl.stack_frames(frames, device=CPU)
    keep = torch.ones((len(frames), 2), dtype=torch.float32)
    with torch.no_grad():
        inputs = pl.build_model_inputs_batch(batch, anchors, keep, cfg, ext)
        out = model(inputs)
        return pl.decode_batch(out, batch.ground_plane, cfg, ext)


def test_off_is_one_shared_no_op():
    assert profiling._active is None
    first = profiling.span("detector")
    assert profiling.span("decode.nms") is first
    with first:
        pass
    with profiling.collect() as col:
        pass
    assert col.summary() == {"spans": {}}
    assert profiling.span("detector") is first


def test_nesting_parents_requests_self_time_and_counts(monkeypatch):
    clock = iter(range(0, 10**9, 10**6))  # 1 ms a reading
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(clock))
    with profiling.collect() as col:
        with profiling.span("a"):  # reads 0 .. 5
            with profiling.span("a.b"):  # 1 .. 2
                pass
            with profiling.span("a.c"):  # 3 .. 4
                pass
        assert col.next_request() == 1
        with profiling.span("a"):  # 6 .. 7
            pass
    assert profiling._active is None
    assert [(s.name, s.request) for s in col.spans] == [("a.b", 0), ("a.c", 0), ("a", 0), ("a", 1)]
    spans = col.summary()["spans"]
    assert {k: v["parent"] for k, v in spans.items()} == {"a": None, "a.b": "a", "a.c": "a"}
    assert spans["a"]["request"] == [0, 1]
    assert spans["a"]["host_ms"] == spans["a"]["device_ms"] == [5.0, 1.0]
    assert spans["a"]["self_ms"] == [3.0, 1.0]
    assert spans["a.b"] == {"parent": "a", "request": [0], "host_ms": [1.0], "device_ms": [1.0],
                            "self_ms": [1.0]}


def test_spans_of_one_name_in_a_request_add_up(monkeypatch):
    clock = iter(range(0, 10**9, 10**6))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(clock))
    with profiling.collect() as col:
        for _ in range(3):
            with profiling.span("x"):
                pass
    assert col.summary()["spans"]["x"]["host_ms"] == [3.0]


def test_another_thread_records_nothing():
    import threading

    with profiling.collect() as col:
        t = threading.Thread(target=lambda: profiling.span("x").__enter__())
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert col.summary() == {"spans": {}}


def test_serving_records_the_span_tree_and_the_nms_rounds(server, monkeypatch):
    """The NMS spans hold every greedy round of a request, and as many as
    the config asks for: a reading of their host time a round divides by
    ``eval_nms_size + classes x nms_size``."""

    from sparse_pooling_tpu_torch.models import detector
    from sparse_pooling_tpu_torch.ops import nms

    cfg, _, _, _, batches = server
    rounds = {}

    def counted(module):
        inner = module.nms_batch

        def nms_batch(boxes, scores, max_outputs, *args, **kwargs):
            col = profiling._active
            assert col.stack[-1].name in NMS_SPANS
            rounds[col.request] = rounds.get(col.request, 0) + max_outputs
            return inner(boxes, scores, max_outputs, *args, **kwargs)

        monkeypatch.setattr(module, "nms_batch", nms_batch)

    counted(nms)
    counted(detector)
    with profiling.collect(CPU) as col:
        for frames in batches:
            col.next_request()
            serve(server, frames)
    got = col.summary()
    assert {k: v["parent"] for k, v in got["spans"].items()} == TREE
    for name, s in got["spans"].items():
        assert s["request"] == [1, 2], name
        assert all(h > 0 for h in s["host_ms"]), name
    per_request = cfg.rpn.eval_nms_size + cfg.num_classes * cfg.avod.nms_size
    assert rounds == {1: per_request, 2: per_request}
    det = got["spans"]["detector"]
    kids = [got["spans"][k]["device_ms"] for k, p in TREE.items() if p == "detector"]
    for r in range(2):
        assert det["self_ms"][r] == pytest.approx(det["device_ms"][r] - sum(k[r] for k in kids))


def test_outputs_are_the_same_with_tracing_on_and_off(server):
    frames = server[4][0]
    off = serve(server, frames)
    with profiling.collect(CPU):
        on = serve(server, frames)
    assert set(on) == set(off)
    for k in off:
        assert torch.equal(on[k], off[k]), k


def test_off_makes_no_event_and_no_range(server, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    def refuse(*_args, **_kwargs):
        raise AssertionError("made while tracing is off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(server, server[4][0])
    assert not [e for e in prof.events() if e.name.startswith(profiling.RANGE_PREFIX)]


def test_each_span_is_a_profiler_range_around_its_ops(server):
    from torch.profiler import ProfilerActivity, profile

    cfg = server[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.collect(CPU):
        serve(server, server[4][0])
    events = prof.events()
    ranges = {}
    for e in events:
        if e.name.startswith(profiling.RANGE_PREFIX):
            assert e.name[len(profiling.RANGE_PREFIX):] not in ranges, e.name
            ranges[e.name[len(profiling.RANGE_PREFIX):]] = (e.time_range.start, e.time_range.end)
    assert set(ranges) == set(TREE)
    for name, parent in TREE.items():
        if parent is not None:
            assert ranges[parent][0] <= ranges[name][0] <= ranges[name][1] <= ranges[parent][1], name

    def inside(name, e):
        return ranges[name][0] <= e.time_range.start and e.time_range.end <= ranges[name][1]

    # one argmax a greedy round, all of them inside the two NMS spans
    argmax = [e for e in events if e.name == "aten::argmax"]
    assert sum(inside("detector.rpn_nms", e) for e in argmax) == cfg.rpn.eval_nms_size
    assert sum(inside("decode.nms", e) for e in argmax) == cfg.num_classes * cfg.avod.nms_size
    convs = [e for e in events if e.name == "aten::convolution"]
    assert convs and all(inside("detector", e) for e in convs)
    assert any(inside("detector.encode", e) for e in convs)


def test_trace_writes_the_spans_into_its_chrome_trace(server, tmp_path):
    with profiling.trace(str(tmp_path)):
        serve(server, server[4][0])
    text = (tmp_path / "trace.json").read_text()
    for name in TREE:
        assert f'"{profiling.RANGE_PREFIX}{name}"' in text, name
    assert profiling._active is None


@pytest.mark.cuda
def test_device_stream_time_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    x = torch.randn(2048, 2048, device=dev)
    with profiling.collect(dev) as col:
        with profiling.span("mm"):
            for _ in range(20):
                x = x @ x / 2048
    s = col.summary()["spans"]["mm"]
    assert s["device_ms"][0] > 0 and s["self_ms"] == s["device_ms"]
