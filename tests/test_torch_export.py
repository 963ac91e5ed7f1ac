"""The port's serving export (``runtime/export.py``) against the live
pipeline and against the JAX package's export.

The three cases of ``tests/test_export.py`` on the port (the artifact
against the live pipeline within 1e-5, the disk round trip bit for bit, the
input spec against the dataset's batch layout), a fresh process that loads
the artifact and gives the same bits, the port's exported detections
against JAX's ``export_inference(...).call`` at the cars parity config of
``tests/test_torch_model.py`` (weights carried over by ``weights.from_flax``;
the tolerance of ``test_slice_detections_match_jax``), the rcnn parity
config exported, and the CLI. Everything runs on the CPU (the kernels'
plain twins behind the ``torch.ops.spt`` operators).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
pytest.importorskip("flax")  # the JAX package imports flax

from sparse_pooling_tpu.configs import config as jcfg_mod  # noqa: E402
from sparse_pooling_tpu.models import pipeline as j_pl  # noqa: E402
from sparse_pooling_tpu.runtime import export as j_export  # noqa: E402
from sparse_pooling_tpu_torch import weights  # noqa: E402
from sparse_pooling_tpu_torch.configs import cars_pyramid_config, unittest_config  # noqa: E402
from sparse_pooling_tpu_torch.configs.presets import rcnn_cars_config  # noqa: E402
from sparse_pooling_tpu_torch.data.dataset import MAX_GT_BOXES, KittiDataset  # noqa: E402
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame  # noqa: E402
from sparse_pooling_tpu_torch.experiments import export_model  # noqa: E402
from sparse_pooling_tpu_torch.models import detector as t_det  # noqa: E402
from sparse_pooling_tpu_torch.models import pipeline as t_pl  # noqa: E402
from sparse_pooling_tpu_torch.runtime import export as export_mod  # noqa: E402
from test_torch_model import T_EXT, _np_tree, _to_jax_model_cfg, parity_config  # noqa: E402
from test_torch_rcnn import rcnn_parity_config  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _live(model, batch, cfg, ext):
    anchors = t_pl.static_anchor_grid(cfg, ext, device="cpu")
    out = t_pl.forward_batch_fn(model, batch, anchors, cfg, ext)
    return t_pl.decode_batch(out, batch.ground_plane, cfg, ext)


@pytest.fixture(scope="module")
def setup(kitti_root):
    """The unittest preset over the tree's trainval split, seeded weights,
    one dataset batch of 2 and its export."""

    cfg = unittest_config(dataset_root=kitti_root)
    cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(cfg.dataset, split="trainval"))
    model = t_pl.make_model(cfg.model, device="cpu")
    weights.init_like_flax(model, seed=0)
    arrays, _ = next(KittiDataset(cfg.dataset, cfg.model).batches(2, 0, augment=False))
    batch = t_pl.RawSample(*(torch.from_numpy(a) for a in arrays))
    ep = export_mod.export_inference(cfg, model, batch_size=2, device="cpu")
    return cfg, model, batch, ep


def test_export_matches_live_pipeline(setup):
    cfg, model, batch, ep = setup
    got = ep.module()(*batch)
    want = _live(model, batch, cfg.model, export_mod.AreaExtents())
    assert sorted(got) == sorted(want)
    assert want["valid"].any()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)
    # the config's pixel scales are constants of the program
    consts = [c for c in ep.constants.values() if isinstance(c, torch.Tensor)]
    for scale in t_det.px_scales(cfg.model, export_mod.AreaExtents(), "cpu"):
        assert any(c.shape == scale.shape and torch.equal(c, scale) for c in consts)


def test_export_disk_round_trip(setup, tmp_path):
    cfg, model, batch, ep = setup
    path = str(tmp_path / "unittest_b2.pt2")
    n = export_mod.save_exported(ep, path)
    assert n == os.path.getsize(path) > 1000
    fn = export_mod.load_serving_fn(path)
    assert fn.device_type == "cpu"
    got, want = fn(batch), ep.module()(*batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="exported for cpu"):
        fn(t_pl.RawSample(*(t.to("meta") for t in batch)))


def test_input_spec_matches_dataset_layout(setup):
    cfg, _, batch, _ = setup
    spec = export_mod.serving_input_spec(cfg, batch_size=2)
    for name, s, a in zip(spec._fields, spec, batch):
        assert s.shape == a.shape, name
        assert s.dtype == a.dtype, name
    assert spec.gt_boxes_3d.shape[1] == MAX_GT_BOXES


def test_a_fresh_process_loads_the_artifact(setup, tmp_path):
    """A new interpreter that imports only ``runtime.export`` loads the file
    and gives the same bits."""

    _, _, batch, ep = setup
    path, inputs, outputs = (str(tmp_path / n) for n in ("a.pt2", "batch.pt", "out.pt"))
    export_mod.save_exported(ep, path)
    torch.save(tuple(batch), inputs)
    code = ("import sys, torch; from sparse_pooling_tpu_torch.runtime import export as e; "
            "from sparse_pooling_tpu_torch.models.pipeline import RawSample; "
            "fn = e.load_serving_fn(sys.argv[1]); "
            "torch.save(fn(RawSample(*torch.load(sys.argv[2]))), sys.argv[3])")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    subprocess.run([sys.executable, "-c", code, path, inputs, outputs], check=True, env=env, cwd=tmp_path,
                   timeout=300)
    got, want = torch.load(outputs), ep.module()(*batch)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _parity_frames(cfg):
    frames = [synthetic_frame(cfg, n_points=1024, seed=s, image="noise") for s in (0, 1)]
    for f in frames:  # the serving layout's gt fields (unused by the forward)
        for k in ("gt_boxes_3d", "gt_valid", "gt_classes"):
            pad = [(0, MAX_GT_BOXES - f[k].shape[0])] + [(0, 0)] * (f[k].ndim - 1)
            f[k] = np.pad(f[k], pad)
    return frames


def test_exported_detections_match_jax_export():
    cfg = parity_config()
    frames = _parity_frames(cfg)
    jcfg = _to_jax_model_cfg(cfg)
    jpipe = jcfg_mod.pipeline_config_from_dict(dataclasses.asdict(dataclasses.replace(cars_pyramid_config(),
                                                                                      model=cfg)))
    jext = jcfg_mod.AreaExtents(**dataclasses.asdict(T_EXT))
    jmodel = j_pl.make_model(jcfg, jext)
    janchors = jnp.array(j_pl.static_anchor_grid(jcfg, jext))
    jbatch = j_pl.RawSample(**{k: jnp.array(np.stack([f[k] for f in frames])) for k in j_pl.RawSample._fields})

    def init(key, batch):
        raw0 = jax.tree.map(lambda x: x[0], batch)
        inputs = j_pl.build_model_inputs(raw0, janchors, jnp.ones((2,), jnp.float32), jcfg, jext)
        return jmodel.init({"params": key, "dropout": key}, inputs, train=False)

    params = jax.jit(init)(jax.random.PRNGKey(0), jbatch)
    jdet = j_export.export_inference(jpipe, params, batch_size=2, extents=jext).call(jbatch)

    model = t_pl.make_model(cfg, T_EXT, device="cpu")
    model.load_state_dict(weights.from_flax(_np_tree(params), cfg), strict=True)
    tcfg = dataclasses.replace(cars_pyramid_config(), model=cfg)
    ep = export_mod.export_inference(tcfg, model, batch_size=2, extents=T_EXT, device="cpu")
    tdet = ep.module()(*t_pl.stack_frames(frames, device="cpu"))
    np.testing.assert_array_equal(tdet["valid"].numpy(), np.asarray(jdet["valid"]))
    assert tdet["valid"].any()
    np.testing.assert_allclose(tdet["scores"].numpy(), np.asarray(jdet["scores"]), atol=1e-5)
    np.testing.assert_allclose(tdet["boxes_3d"].numpy(), np.asarray(jdet["boxes_3d"]), atol=1e-4)


def test_rcnn_export_matches_live_pipeline():
    cfg = rcnn_parity_config()
    model = t_pl.make_model(cfg, T_EXT, device="cpu")
    weights.init_like_flax(model, seed=0)
    batch = t_pl.stack_frames(_parity_frames(cfg), device="cpu")
    ep = export_mod.export_inference(dataclasses.replace(rcnn_cars_config(), model=cfg), model, batch_size=2,
                                     extents=T_EXT, device="cpu")
    got, want = ep.module()(*batch), _live(model, batch, cfg, T_EXT)
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_export_model_cli(kitti_root, tmp_path):
    """``--verify`` without ``--workdir``: seeded weights over a tree the
    port writes, the artifact against the live pipeline."""

    out = str(tmp_path / "unittest_b2.pt2")
    res = export_model.main(["--preset", "unittest", "--out", out, "--batch", "2", "--device", "cpu", "--verify"])
    assert res["bytes"] == os.path.getsize(out) and res["device"] == "cpu" and res["max_abs_err"] <= 1e-5
