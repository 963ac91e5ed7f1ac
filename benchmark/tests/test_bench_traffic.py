"""The traffic: the same seed gives the same frames and requests, another
seed others, and every seed the same set of point counts."""

from __future__ import annotations

import numpy as np

from bench_fixtures import tiny_pipeline


def _cfg():
    from sparse_pooling_tpu_torch.configs.config import pipeline_config_from_dict

    return pipeline_config_from_dict(tiny_pipeline()).model


MIX = {"kind": "serve", "batch": 2, "pool_frames": 6, "points_min": 600, "points_max": 1000, "image": "noise"}


def _pool(seed):
    from traffic import frame_pool

    return frame_pool(MIX, _cfg(), seed)


def test_same_seed_same_frames_and_requests():
    from traffic import ServeSchedule

    a, b = _pool(3_000_000_019), _pool(3_000_000_019)
    for fa, fb in zip(a, b):
        for key in fa:
            np.testing.assert_array_equal(fa[key], fb[key])
    sa, sb = ServeSchedule(MIX, 3_000_000_019), ServeSchedule(MIX, 3_000_000_019)
    assert [sa.request(i) for i in range(9)] == [sb.request(i) for i in range(9)]


def test_other_seed_other_frames_and_order_same_sizes():
    from traffic import ServeSchedule

    a, b = _pool(11), _pool(12)
    assert any(not np.array_equal(fa["points"], fb["points"]) for fa, fb in zip(a, b))
    assert any(not np.array_equal(fa["image"], fb["image"]) for fa, fb in zip(a, b))
    counts = [sorted(int(f["points_mask"].sum()) for f in pool) for pool in (a, b)]
    assert counts[0] == counts[1] == sorted(np.rint(np.linspace(600, 1000, 6)).astype(int).tolist())
    sa, sb = ServeSchedule(MIX, 11), ServeSchedule(MIX, 12)
    ra, rb = [sa.request(i) for i in range(6)], [sb.request(i) for i in range(6)]
    assert ra != rb
    for reqs in (ra, rb):  # each pass uses every frame once, in distinct pairs
        for p in range(2):
            ids = sum(reqs[3 * p:3 * p + 3], [])
            assert sorted(ids) == list(range(6))
