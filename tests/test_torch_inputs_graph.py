"""The input build replayed as CUDA graphs (``pipeline.build_model_inputs_batch``
over ``runtime/graphs.GraphedCall``): on a card with autograd off, for a family
whose ``frame_inputs`` wait on nothing on the host, each input signature is
captured once and replayed, bit for bit the eager build, into tensors the
caller owns; everywhere else the build runs eagerly. ``input_graph_counts``
says which way each call went.

Runs without JAX (``pytest --noconftest tests/test_torch_inputs_graph.py`` on
a machine with a card). The card tests skip where
``torch.cuda.is_available()`` is false.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sparse_pooling_tpu_torch.configs import AreaExtents, presets
from sparse_pooling_tpu_torch.data.pointcloud import trim_points_to_bucket
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame
from sparse_pooling_tpu_torch.models import pipeline as pl
from sparse_pooling_tpu_torch.ops.sparse_build import DeviceCoo
from sparse_pooling_tpu_torch.runtime import graphs, profiling
from test_torch_families import small, small_frames

EXT = AreaExtents()
PRESETS = {"avod": presets.cars_pyramid_config, "rcnn": presets.rcnn_cars_config,
           "mv3d": presets.mv3d_cars_config}


def delta(before):
    after = pl.input_graph_counts()
    return {k: after[k] - before[k] for k in after}


def build(cfg, batch, anchors):
    keep = torch.ones((batch.points.shape[0], 2), dtype=torch.float32, device=batch.points.device)
    return pl.build_model_inputs_batch(batch, anchors, keep, cfg, EXT)


def tensors(inputs):
    """Every tensor of a built input dict by name (a COO table's fields as
    ``<name>.<field>``)."""

    out = {}
    for name, v in inputs.items():
        if isinstance(v, DeviceCoo):
            out.update({f"{name}.{f}": getattr(v, f) for f in ("rows", "cols", "vals")})
        elif isinstance(v, torch.Tensor):
            out[name] = v
    return out


# -- on the CPU --------------------------------------------------------------


@pytest.mark.parametrize("architecture", list(PRESETS))
def test_the_cpu_builds_eagerly(architecture):
    cfg = small(architecture)
    batch = pl.stack_frames(small_frames(cfg), device="cpu")
    anchors = pl.static_anchor_grid(cfg, EXT, device="cpu")
    before = pl.input_graph_counts()
    with torch.no_grad():
        first = build(cfg, batch, anchors)
        second = build(cfg, batch, anchors)
    assert delta(before) == {"captures": 0, "replays": 0, "eager": 2}
    assert first["p2"] is batch.p2
    for name, t in tensors(first).items():
        assert torch.equal(t, tensors(second)[name]), name


@pytest.mark.parametrize("architecture,wait_free", [("avod", False), ("rcnn", True), ("mv3d", True)])
def test_each_family_declares_whether_its_frame_inputs_wait(architecture, wait_free):
    assert pl.FAMILIES[architecture].frame_inputs_wait_free is wait_free


def request(architecture, points, seed, n=2):
    """``n`` frames of the family's preset trimmed to the smallest bucket
    that holds them, as the serving harness does (MV3D's with a seeded
    intensity), stacked on the CPU."""

    cfg = PRESETS[architecture]().model
    frs = []
    for k in range(n):
        f = synthetic_frame(cfg, points, seed + k, image="noise")
        if architecture == "mv3d":
            intensity = np.random.default_rng([seed, k]).random(len(f["points"]), dtype=np.float32)
            f["points"] = np.concatenate([f["points"], (intensity * f["points_mask"])[:, None]], axis=1)
        frs.append(f)
    pts, mask = trim_points_to_bucket(np.stack([f["points"] for f in frs]),
                                      np.stack([f["points_mask"] for f in frs]), cfg.sparse_pool.buckets)
    return [dict(f, points=p, points_mask=m) for f, p, m in zip(frs, pts, mask)]


@pytest.mark.parametrize("change", ["values", "bucket", "image", "image_scale"])
def test_the_signature_tells_apart_what_changes_the_work(change):
    cfg = presets.rcnn_cars_config().model
    anchors = pl.static_anchor_grid(cfg, EXT, device="cpu")
    keep = torch.ones((2, 2))
    frs = request("rcnn", 6000, 3)
    other = {
        "values": request("rcnn", 6000, 9),
        "bucket": request("rcnn", 12000, 3),
        "image": [dict(f, image=f["image"][:-8]) for f in frs],
        "image_scale": [{k: v for k, v in f.items() if k != "image_scale"} for f in frs],
    }[change]
    a, b = (pl.input_signature(pl.stack_frames(x, device="cpu"), anchors, keep, cfg, EXT) for x in (frs, other))
    assert (a == b) is (change == "values")
    assert hash(a) == hash(pl.input_signature(pl.stack_frames(frs, device="cpu"), anchors, keep, cfg, EXT))


def test_a_call_owns_fresh_outputs_and_its_own_inputs():
    """``graphs._fresh``: a captured input comes back as the caller's
    tensor, every other tensor as a fresh copy with its strides, through
    dicts, tuples and dataclasses; other values as they are."""

    mine, theirs = torch.arange(4.0), torch.arange(4.0) + 10
    made = torch.arange(6.0).reshape(2, 3).t()
    coo = DeviceCoo(made, made, made, (1, 2), (3, 4), True)
    out = graphs._fresh({"in": mine, "made": made, "coo": coo, "pair": (made, 3), "flag": True},
                        {id(mine): theirs})
    assert out["in"] is theirs and out["flag"] is True and out["pair"][1] == 3
    for t in (out["made"], out["coo"].rows, out["coo"].vals, out["pair"][0]):
        assert torch.equal(t, made) and t.stride() == made.stride()
        assert t.untyped_storage().data_ptr() != made.untyped_storage().data_ptr()
    assert (out["coo"].target_hw, out["coo"].source_hw, out["coo"].defer_row_norm) == ((1, 2), (3, 4), True)


def test_routed_spans_go_to_the_target_or_nowhere():
    seen = []

    class Target:
        thread = profiling.Collection().thread

        def span(self, name):
            seen.append(name)
            return profiling._NOOP

    with profiling.collect() as col:
        with profiling.routed(None):
            assert profiling.span("inputs") is profiling._NOOP
        with profiling.routed(Target()):
            with profiling.span("inputs.front_view"):
                pass
        with profiling.span("inputs"):
            pass
    assert seen == ["inputs.front_view"]
    assert list(col.summary()["spans"]) == ["inputs"]
    assert profiling._active is None


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs)")
    return torch.device("cuda")


def served(architecture, seeds, points=20000, n=8):
    """The cell's requests: 8 frames of 20,000 points (the 32768 bucket) a
    seed, on the card, with the preset and its anchors."""

    cfg = PRESETS[architecture]().model
    anchors = pl.static_anchor_grid(cfg, EXT, device="cuda")
    return cfg, anchors, [pl.stack_frames(request(architecture, points, s, n), device="cuda") for s in seeds]


@pytest.mark.cuda
@pytest.mark.parametrize("architecture", ["rcnn", "mv3d"])
def test_replays_are_the_eager_build_bit_for_bit(cuda, architecture):
    """Three batches in turn, each built eagerly (autograd on) and from the
    graphs; every call's outputs are still its own after the later calls."""

    cfg, anchors, batches = served(architecture, (100, 200, 300))
    before = pl.input_graph_counts()
    eager, replayed, kept = [], [], []
    for batch in batches:
        with torch.enable_grad():
            eager.append(build(cfg, batch, anchors))
        with torch.no_grad():
            replayed.append(build(cfg, batch, anchors))
        torch.cuda.synchronize()
        kept.append({k: v.clone() for k, v in tensors(replayed[-1]).items()})
    counted = delta(before)
    assert counted["replays"] == 3 and counted["eager"] == 3 and counted["captures"] <= 1
    for e, r, k, batch in zip(eager, replayed, kept, batches):
        assert set(tensors(e)) == set(tensors(r))
        for name, t in tensors(r).items():
            assert torch.equal(t, tensors(e)[name]), name
            assert torch.equal(t, k[name]), name
        assert r["p2"] is batch.p2 and r["bev_pre_packed"] == e["bev_pre_packed"]
    for name in tensors(replayed[0]):
        assert len({tensors(r)[name].data_ptr() for r in replayed}) == 3, name


@pytest.mark.cuda
def test_a_new_point_bucket_captures_its_own_graphs(cuda):
    cfg, anchors, (small_bucket,) = served("rcnn", (7,), points=5000)
    _, _, (large_bucket,) = served("rcnn", (8,))
    assert small_bucket.points.shape[1] == 8192 and large_bucket.points.shape[1] == 32768
    with torch.no_grad():
        build(cfg, large_bucket, anchors)
        before = pl.input_graph_counts()
        out = build(cfg, small_bucket, anchors)
        again = build(cfg, small_bucket, anchors)
    assert delta(before) == {"captures": 1, "replays": 2, "eager": 0}
    for name, t in tensors(out).items():
        assert torch.equal(t, tensors(again)[name]), name
    keys = [pl.input_signature(b, anchors, torch.ones((8, 2), device=cuda), cfg, EXT)
            for b in (small_bucket, large_bucket)]
    assert keys[0] != keys[1] and all(k in pl._INPUT_GRAPHS for k in keys)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["avod", "grad", "busy"])
def test_avod_autograd_and_a_busy_graph_build_eagerly(cuda, case):
    """AVOD declares that its frame inputs wait on the host; autograd
    builds eagerly for the backward; a call that finds its signature's
    graphs held by another call builds eagerly too, with the same bits."""

    cfg, anchors, (batch,) = served("avod" if case == "avod" else "rcnn", (11,))
    keep = torch.ones((8, 2), device=cuda)
    with torch.no_grad():
        want = build(cfg, batch, anchors) if case == "busy" else None
    before = pl.input_graph_counts()
    if case == "grad":
        with torch.enable_grad():
            build(cfg, batch, anchors)
    elif case == "avod":
        with torch.no_grad():
            build(cfg, batch, anchors)
    else:
        graph = pl._INPUT_GRAPHS[pl.input_signature(batch, anchors, keep, cfg, EXT)]
        with graph.lock, torch.no_grad():
            got = build(cfg, batch, anchors)
        for name, t in tensors(got).items():
            assert torch.equal(t, tensors(want)[name]), name
    assert delta(before) == {"captures": 0, "replays": 0, "eager": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("architecture", ["rcnn", "mv3d"])
def test_spans_time_the_replays(cuda, architecture):
    """``inputs`` around the copies and the replay, MV3D's
    ``inputs.front_view`` inside it around the front view's own graph, both
    with device time."""

    cfg, anchors, (batch,) = served(architecture, (21,))
    with torch.no_grad():
        build(cfg, batch, anchors)
        before = pl.input_graph_counts()
        with profiling.collect(cuda) as col:
            for _ in range(2):
                col.next_request()
                build(cfg, batch, anchors)
            spans = col.summary()["spans"]
    assert delta(before) == {"captures": 0, "replays": 2, "eager": 0}
    names = {"inputs"} | ({"inputs.front_view"} if architecture == "mv3d" else set())
    assert set(spans) == names
    for name in names:
        assert spans[name]["request"] == [1, 2] and min(spans[name]["device_ms"]) > 0, name
    if architecture == "mv3d":
        assert spans["inputs.front_view"]["parent"] == "inputs"
        assert all(a > b for a, b in zip(spans["inputs"]["device_ms"], spans["inputs.front_view"]["device_ms"]))
