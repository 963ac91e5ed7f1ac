"""ContFuse's neighbour search, the operator ``torch.ops.spt.bev_knn``
(``ops/knn.py``, ``csrc/bev_knn.cu``), and the NMS over more candidates than
its kernel holds (``ops/nms.nms_batch``).

On the CPU: the plain twin against a brute force in numpy float32 (each
distance's separate rounded operations, candidates ordered by (distance,
index)), with exact ties, distance limits, a frame of fewer than K valid
points and an empty frame; the operator's refusal of another K or of no
limit; the operator's fake kernel; the counter; ``nms_batch`` over more
candidates than a (monkeypatched) limit against the plain loop over the
full set, and its count of frames whose kept set ran dry.

On the card (marker ``cuda``): the kernel against its twin at the served
size (the 704x800 BEV's four lattices, 187,000 query points, 8 frames of
20,000 of 32,768 point slots), indices equal bit for bit, one launch, and
no host sync under ``torch.cuda.set_sync_debug_mode("error")``; the NMS at
70,400 candidates, and a kept set planted to run dry. No JAX here:
``python3 -m pytest --noconftest -m cuda tests/test_torch_knn.py``.
"""


import numpy as np
import pytest
import torch

from sparse_pooling_tpu_torch.configs.config import AreaExtents
from sparse_pooling_tpu_torch.ops import knn, nms

AREA = (-40.0, 40.0, 0.0, 70.4)


def brute(points, valid, queries, k, max_distance):
    """numpy float32: every distance, rounded at each operation, then the
    k least (d2, index) within the limit; P where fewer."""

    b, p = valid.shape
    r2 = np.float32(np.float32(max_distance) ** 2)
    out = np.full((b, len(queries), k), p, np.int64)
    for f in range(b):
        px, pz = points[f, :, 0].astype(np.float32), points[f, :, 2].astype(np.float32)
        for i, (qx, qz) in enumerate(queries.astype(np.float32)):
            dx, dz = px - qx, pz - qz
            d2 = dx * dx + dz * dz
            keep = np.nonzero(valid[f] & (d2 <= r2))[0]
            order = keep[np.lexsort((keep, d2[keep]))][:k]
            out[f, i, :len(order)] = order
    return out


def frames(b, p, n, seed, ties=True):
    """b frames of p slots, the first n valid, points in the BEV; with
    ``ties`` a block of points copied (equal distances) and points on a
    0.1 m lattice (equal distances in many directions)."""

    rng = np.random.default_rng(seed)
    pts = np.zeros((b, p, 4), np.float32)
    pts[..., 0] = rng.uniform(-30, 30, (b, p))
    pts[..., 1] = rng.uniform(-1, 2, (b, p))
    pts[..., 2] = rng.uniform(0, 60, (b, p))
    if ties:
        pts[:, n // 2:n // 2 + 20, :3] = pts[:, :20, :3]
        pts[:, :40, 0] = np.round(pts[:, :40, 0] * 10) / 10
        pts[:, :40, 2] = np.round(pts[:, :40, 2] * 10) / 10
    valid = np.zeros((b, p), bool)
    valid[:, :n] = True
    return pts, valid


def lattice_queries(rows, cols, cell, extents=AreaExtents()):
    from sparse_pooling_tpu_torch.models.contfuse import lattice_centres

    return lattice_centres(rows, cols, cell, extents, "cpu")


@pytest.mark.parametrize("max_distance", [2.0, 4.0, 10.0, 200.0])
def test_twin_matches_brute_force(max_distance):
    """Limits from one under the points' spacing to past the area's
    diagonal (every query finds its points)."""

    k = knn.K
    pts, valid = frames(3, 300, 250, seed=int(max_distance))
    valid[2, 2:] = False  # fewer than k valid points in frame 2
    q = torch.cat([lattice_queries(11, 13, 6.0), torch.tensor([[0.05, 0.05], [-40.0, 70.4], [1e3, -1e3]])])
    got = knn.bev_knn(torch.from_numpy(pts), torch.from_numpy(valid), q, k, max_distance, AREA)
    want = brute(pts, valid, q.numpy(), k, max_distance)
    assert np.array_equal(got.numpy(), want)
    assert (got < 300).any() and (got == 300).any()


def test_ties_go_to_the_lower_index():
    """Copies of a point are as near as the point: the lower index first."""

    pts, valid = frames(1, 64, 64, seed=5, ties=False)
    pts[0, 40:44, :3] = pts[0, 7, :3]
    q = torch.tensor([[pts[0, 7, 0], pts[0, 7, 2]]], dtype=torch.float32)
    got = knn.bev_knn(torch.from_numpy(pts), torch.from_numpy(valid), q, 3, 10.0, AREA)
    assert got[0, 0].tolist() == [7, 40, 41]


def test_an_empty_frame_and_a_frame_of_fewer_than_k_points():
    pts, valid = frames(2, 50, 50, seed=3)
    valid[0] = False
    valid[1, 2:] = False
    q = lattice_queries(4, 4, 10.0)
    got = knn.bev_knn(torch.from_numpy(pts), torch.from_numpy(valid), q, 3, 200.0, AREA)
    assert (got[0] == 50).all()
    assert (got[1, :, 2] == 50).all() and set(got[1, :, :2].reshape(-1).tolist()) == {0, 1}
    assert np.array_equal(got.numpy(), brute(pts, valid, q.numpy(), 3, 200.0))


def test_no_points_or_no_queries():
    got = knn.bev_knn(torch.zeros(2, 0, 3), torch.zeros(2, 0, dtype=torch.bool), lattice_queries(2, 2, 1.0), 3,
                      10.0, AREA)
    assert got.shape == (2, 4, 3) and (got == 0).all()
    got = knn.bev_knn(torch.zeros(2, 5, 3), torch.ones(2, 5, dtype=torch.bool), torch.zeros(0, 2), 3, 10.0, AREA)
    assert got.shape == (2, 0, 3)


@pytest.mark.parametrize("k,max_distance", [(2, 10.0), (4, 10.0), (3, np.inf), (3, 0.0)])
def test_the_operator_refuses_another_k_or_no_limit(k, max_distance):
    """The kernel keeps 3 neighbours and reads rings up to a finite limit;
    the twin refuses what the kernel refuses."""

    pts, valid = frames(1, 60, 60, seed=2)
    with pytest.raises(ValueError, match="bev_knn"):
        knn.bev_knn(torch.from_numpy(pts), torch.from_numpy(valid), lattice_queries(2, 2, 4.0), k, max_distance,
                    AREA)


def test_fake_kernel_gives_the_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        out = torch.ops.spt.bev_knn(torch.empty(8, 100, 4), torch.empty(8, 100, dtype=torch.bool),
                                    torch.empty(37, 2), 3, 10.0, *AREA)
    assert out.shape == (8, 37, 3) and out.dtype == torch.int64


def test_the_counter_counts_queries_and_distances():
    before = knn.knn_counts()
    pts, valid = frames(2, 40, 30, seed=9)
    knn.bev_knn(torch.from_numpy(pts), torch.from_numpy(valid), lattice_queries(3, 5, 4.0), 3, 200.0, AREA)
    after = knn.knn_counts()
    assert after["calls"] == before["calls"] + 1
    assert after["queries"] - before["queries"] == 2 * 15
    assert after["examined"] - before["examined"] == 15 * 60


def test_the_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="expected cuda"):
        knn.bev_knn_kernel(torch.zeros(1, 4, 3), torch.ones(1, 4, dtype=torch.bool), torch.zeros(2, 2), 3, 10.0,
                           *AREA)


def _nms_case(b, n, seed):
    rng = np.random.RandomState(seed)
    c = rng.uniform(0, np.sqrt(n) * 1.5, (b, n, 2))
    half = rng.uniform(0.3, 1.5, (b, n, 2))
    boxes = torch.from_numpy(np.concatenate([c - half, c + half], -1).astype(np.float32))
    scores = torch.from_numpy(np.floor(rng.rand(b, n) * 64).astype(np.float32) / 64)  # ties
    scores[1, : n // 2] = -torch.inf
    return boxes, scores


@pytest.mark.parametrize("max_outputs,threshold", [(10, 0.5), (40, 0.1), (60, 0.8)])
def test_nms_over_more_candidates_than_the_kernel_holds(monkeypatch, max_outputs, threshold):
    """Above the limit the kept best candidates give the full set's picks
    while a kept one is live; the indices index the full set."""

    boxes, scores = _nms_case(3, 400, seed=max_outputs)
    want = nms.nms_batch_plain(boxes, scores, max_outputs, threshold)
    monkeypatch.setattr(nms, "candidate_limit", lambda b: 300)
    short = nms.short_frames()
    got = nms.nms_batch(boxes, scores, max_outputs, threshold)
    assert torch.equal(got.valid, want.valid) and torch.equal(got.indices, want.indices)
    assert nms.short_frames() == short


def _dry_case(b, n, kept, seed):
    """Frames whose ``kept`` best candidates are one box (the first pick
    suppresses them all) above ``n - kept`` apart."""

    boxes, scores = _nms_case(b, n, seed)
    scores = torch.rand(b, n, generator=torch.Generator().manual_seed(seed))
    top = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :kept]
    boxes.scatter_(1, top[..., None].expand(-1, -1, 4), boxes[:, :1].expand(-1, kept, -1).contiguous())
    return boxes, scores


def test_nms_counts_a_kept_set_that_runs_dry(monkeypatch):
    """The 300 best candidates are one box: the kept set gives one pick
    where the full set gives more. Each frame is counted, nothing waits."""

    boxes, scores = _dry_case(2, 400, 300, seed=3)
    monkeypatch.setattr(nms, "candidate_limit", lambda b: 300)
    short = nms.short_frames()
    got = nms.nms_batch(boxes, scores, 20, 0.5)
    want = nms.nms_batch_plain(boxes, scores, 20, 0.5)
    assert got.valid.sum(1).tolist() == [1, 1] and (want.valid.sum(1) > 1).all()
    assert nms.short_frames() == short + 2


def test_nms_ties_at_the_limit_keep_the_lower_index(monkeypatch):
    """Equal scores across the kept set's edge: the lower indices are kept,
    as the plain loop over the full set picks them."""

    boxes, scores = _nms_case(2, 400, seed=6)
    scores[:] = 0.5
    monkeypatch.setattr(nms, "candidate_limit", lambda b: 300)
    got = nms.nms_batch(boxes, scores, 40, 0.5)
    want = nms.nms_batch_plain(boxes, scores, 40, 0.5)
    assert torch.equal(got.indices, want.indices) and torch.equal(got.valid, want.valid)


def test_nms_at_or_under_the_limit_takes_one_call(monkeypatch):
    """A call at the limit reaches the operator once, with the full set."""

    boxes, scores = _nms_case(2, 300, seed=1)
    seen = []
    op = torch.ops.spt.greedy_nms

    class Spy:
        def __getattr__(self, name):
            return getattr(torch.ops.spt, name)

        def greedy_nms(self, b, s, k, t):
            seen.append(b.shape)
            return op(b, s, k, t)

    monkeypatch.setattr(nms, "candidate_limit", lambda b: 300)
    monkeypatch.setattr(nms.torch, "ops", type("Ops", (), {"spt": Spy()})())
    got = nms.nms_batch(boxes, scores, 20, 0.5)
    assert seen == [torch.Size([2, 300, 4])]
    want = nms.nms_batch_plain(boxes, scores, 20, 0.5)
    assert torch.equal(got.indices, want.indices) and torch.equal(got.valid, want.valid)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def served_queries():
    """The 704x800 BEV's four fused lattices (1/2 .. 1/16), in order."""

    from sparse_pooling_tpu_torch.configs.presets import contfuse_cars_config
    from sparse_pooling_tpu_torch.models.contfuse import knn_centres

    cfg = contfuse_cars_config().model
    return cfg, knn_centres(torch.tensor([[0.0, -1.0, 0.0, 1.65]]), cfg, AreaExtents())[0, :, 0::2].contiguous()


@pytest.mark.cuda
def test_kernel_matches_twin_at_the_served_size(cuda):
    from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame
    from sparse_pooling_tpu_torch.models.contfuse import knn_area
    from sparse_pooling_tpu_torch.ops.bev_device import points_in_extents

    cfg, q = served_queries()
    assert q.shape == (187_000, 2)
    frames_ = [synthetic_frame(cfg, 20_000, seed) for seed in range(8)]
    pts = torch.from_numpy(np.stack([f["points"] for f in frames_])).to(cuda)
    pts[:, 19_980:20_000] = pts[:, :20]  # exact ties
    mask = torch.from_numpy(np.stack([f["points_mask"] for f in frames_])).to(cuda)
    valid = points_in_extents(pts, mask, AreaExtents())
    q = q.to(cuda)
    area = knn_area(cfg, AreaExtents())
    k, dist = cfg.contfuse.neighbours, cfg.contfuse.max_distance
    launches = knn.bev_knn_kernel.launches
    got = knn.bev_knn(pts, valid, q, k, dist, area)
    assert knn.bev_knn_kernel.launches == launches + 1
    want = knn.bev_knn_plain(pts, valid, q, k, dist, *area)
    assert torch.equal(got, want)
    assert (got < 32_768).float().mean().item() > 0.3 and (got == 32_768).any()
    # a limit past the area's diagonal: every query finds k points
    got = knn.bev_knn(pts, valid, q, k, 200.0, area)
    assert torch.equal(got, knn.bev_knn_plain(pts, valid, q, k, 200.0, *area))
    assert (got < 32_768).all()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = knn.bev_knn(pts, valid, q, k, dist, area)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(again, want)


@pytest.mark.cuda
def test_kernel_edges_on_card(cuda):
    k = knn.K
    for case, (b, p, n, dist) in enumerate([(1, 1, 1, 200.0), (3, 300, 250, 4.0), (2, 50, 0, 200.0),
                                            (2, 1000, 2, 10.0)]):
        pts, valid = frames(b, p, n, seed=case)
        q = torch.cat([lattice_queries(11, 13, 6.0), torch.tensor([[0.05, 0.05], [-40.0, 70.4], [1e3, -1e3]])])
        got = knn.bev_knn(torch.from_numpy(pts).to(cuda), torch.from_numpy(valid).to(cuda), q.to(cuda), k, dist, AREA)
        assert np.array_equal(got.cpu().numpy(), brute(pts, valid, q.numpy(), k, dist)), case


@pytest.mark.cuda
def test_nms_over_the_kernel_limit_on_card(cuda):
    """70,400 candidates a frame (ContFuse's header) through the kernel's
    kept set against the plain loop over all of them."""

    boxes, scores = _nms_case(2, 70_400, seed=4)
    scores = torch.rand(2, 70_400, generator=torch.Generator().manual_seed(0))
    want = nms.nms_batch_plain(boxes.to(cuda), scores.to(cuda), 100, 0.1)
    short = nms.short_frames()
    got = nms.nms_batch(boxes.to(cuda), scores.to(cuda), 100, 0.1)
    assert torch.equal(got.valid, want.valid) and torch.equal(got.indices, want.indices)
    assert nms.short_frames() == short


@pytest.mark.cuda
def test_nms_kept_set_runs_dry_on_card(cuda):
    """The kernel's 57,344 best of 70,400 candidates planted as one box:
    one pick from the kept set, both frames counted on the card, no host
    sync on the way."""

    limit = nms.max_candidates()
    boxes, scores = _dry_case(2, 70_400, limit, seed=5)
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    short = nms.short_frames()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = nms.nms_batch(boxes, scores, 100, 0.1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got.valid.sum(1).tolist() == [1, 1]
    assert nms.short_frames() == short + 2
