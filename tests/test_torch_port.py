"""Rules of the PyTorch port that need no JAX, and its kernels on the card.

Runs without JAX (``pytest --noconftest tests/test_torch_port.py`` on a
machine with a card): the import boundary, device handling, dispatch by
tensor device, and each CUDA kernel against its plain twin. The card tests
skip where ``torch.cuda.is_available()`` is false.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from sparse_pooling_tpu_torch import kernels
from sparse_pooling_tpu_torch.configs import AreaExtents, cars_pyramid_config
from sparse_pooling_tpu_torch.configs.presets import rcnn_cars_config
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame
from sparse_pooling_tpu_torch.models import pipeline as pl
from sparse_pooling_tpu_torch.ops import crop_resize, ell_sparse_pool, sparse_pool

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "sparse_pooling_tpu", "__graft_entry__", "PIL")


def _port_files():
    files = sorted((REPO / "sparse_pooling_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_no_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    for path in files:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_import_check_covers_the_training_modules():
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for module in ("ops/iou.py", "ops/losses.py", "ops/target_assign.py", "models/loss.py",
                   "runtime/trainer.py", "runtime/checkpoint.py", "runtime/summary.py"):
        assert f"sparse_pooling_tpu_torch/{module}" in names, module


def test_import_check_covers_the_kitti_data_modules():
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for module in ("data/labels.py", "data/calib.py", "data/pointcloud.py", "data/augmentation.py",
                   "data/dataset.py", "data/synthetic.py", "data/prefetch.py",
                   "native/sample_loader.py", "experiments/run_training.py"):
        assert f"sparse_pooling_tpu_torch/{module}" in names, module


def test_import_check_covers_the_eval_modules():
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for module in ("runtime/metrics.py", "runtime/predictions.py", "runtime/evaluator.py",
                   "runtime/profiling.py", "native/cxx.py", "native/kitti_eval.py", "native/pred_format.py",
                   "experiments/run_evaluation.py", "experiments/run_inference.py"):
        assert f"sparse_pooling_tpu_torch/{module}" in names, module


def test_import_check_covers_the_rcnn_module():
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert "sparse_pooling_tpu_torch/models/fusion_rcnn.py" in names


def test_import_check_covers_the_contfuse_modules():
    """The ContFuse family, its KNN operator and its test reference import
    neither JAX nor the JAX package; the reference no kernel of the port."""

    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for module in ("models/contfuse.py", "ops/knn.py"):
        assert f"sparse_pooling_tpu_torch/{module}" in names, module
    for path in (REPO / "tests" / "contfuse_reference.py", REPO / "benchmark" / "reference" / "contfuse.py"):
        roots = _imported_roots(path)
        assert not roots & set(FORBIDDEN), path
        assert roots <= {"__future__", "dataclasses", "math", "typing", "numpy", "torch", "sparse_pooling_tpu_torch"}
    port = [node.module for node in ast.walk(ast.parse((REPO / "tests" / "contfuse_reference.py").read_text()))
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("sparse_pooling_tpu_torch")]
    assert port == ["sparse_pooling_tpu_torch.models.layers"]  # plain NHWC wrappers of torch.nn, no kernel
    assert "sparse_pooling_tpu_torch" not in _imported_roots(REPO / "benchmark" / "reference" / "contfuse.py")


def test_import_check_covers_the_export_preprocess_and_demo_modules():
    """No JAX, no PIL and no ``sparse_pooling_tpu`` in the serving export,
    the offline preprocessing, its host data modules and the demos."""

    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for module in ("runtime/export.py", "experiments/export_model.py", "runtime/preprocess.py",
                   "data/voxel_grid.py", "data/bev.py", "data/integral_image.py", "demos/__init__.py",
                   "demos/raster.py", "demos/vis_utils.py", "demos/show_predictions.py"):
        assert f"sparse_pooling_tpu_torch/{module}" in names, module
        assert not _imported_roots(REPO / "sparse_pooling_tpu_torch" / module) & set(FORBIDDEN), module


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["make_model", "static_anchor_grid", "stack_frames", "make_model rcnn",
                                   "static_anchor_grid rcnn"])
def test_entry_points_raise_without_cuda_unless_cpu(no_cuda, entry):
    cfg = cars_pyramid_config().model
    rcnn = rcnn_cars_config().model
    calls = {
        "make_model": lambda dev: pl.make_model(cfg, device=dev),
        "static_anchor_grid": lambda dev: pl.static_anchor_grid(cfg, AreaExtents(), device=dev),
        "stack_frames": lambda dev: pl.stack_frames([synthetic_frame(cfg, 64, 0)], device=dev),
        "make_model rcnn": lambda dev: pl.make_model(rcnn, device=dev),
        "static_anchor_grid rcnn": lambda dev: pl.static_anchor_grid(rcnn, AreaExtents(), device=dev),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]("cuda:0")
    assert calls[entry]("cpu") is not None


def _small_inputs(seed=0):
    rng = np.random.RandomState(seed)
    src = torch.from_numpy(rng.randn(2, 5, 7, 4).astype(np.float32))
    rows = torch.from_numpy(rng.randint(0, 11, (2, 30)).astype(np.int32))
    c00 = rng.randint(0, 4, (2, 30)) * 7 + rng.randint(0, 6, (2, 30))
    cols = torch.from_numpy(np.stack([c00, c00 + 1, c00 + 7, c00 + 8], -1).astype(np.int32))
    vals = torch.from_numpy(rng.rand(2, 30, 4).astype(np.float32))
    return src, rows, cols, vals


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = (sparse_pool.sparse_pool_patch_kernel.launches,
              ell_sparse_pool.sparse_pool_ell_kernel.launches,
              crop_resize.crop_and_resize_group_kernel.launches)
    src, rows, cols, vals = _small_inputs()
    out = sparse_pool.sparse_pool_patch_major_batch(src, rows, cols, vals, 11, True)
    torch.testing.assert_close(out, sparse_pool.sparse_pool_patch_plain(src, rows, cols, vals, 11, True)[0])
    idx = rows[0].reshape(10, 3)
    w = vals[0, :10, :3].contiguous()
    x = src[0].reshape(35, 4)
    torch.testing.assert_close(ell_sparse_pool.sparse_pool_fused(x, idx, w), sparse_pool.sparse_pool_ell(x, idx, w))
    xb, idxb, wb = src.reshape(2, 35, 4), rows.reshape(2, 10, 3), vals[:, :10, :3].contiguous()
    torch.testing.assert_close(ell_sparse_pool.sparse_pool_ell_batch(xb, idxb, wb),
                               sparse_pool.sparse_pool_ell_batch_plain(xb, idxb, wb))
    boxes = torch.rand(2, 3, 4, 4) * 5
    torch.testing.assert_close(
        crop_resize.crop_and_resize_group_einsum_px(src, boxes, (3, 3), 4),
        crop_resize.crop_and_resize_group_plain(src, boxes, (3, 3), 4),
    )
    after = (sparse_pool.sparse_pool_patch_kernel.launches,
             ell_sparse_pool.sparse_pool_ell_kernel.launches,
             crop_resize.crop_and_resize_group_kernel.launches)
    assert after == before


def test_kernel_wrappers_refuse_cpu_tensors():
    src, rows, cols, vals = _small_inputs()
    with pytest.raises(ValueError, match="expected cuda"):
        sparse_pool.sparse_pool_patch_kernel(src, rows, cols, vals, 11, True)
    with pytest.raises(ValueError, match="expected cuda"):
        ell_sparse_pool.sparse_pool_ell_kernel(src[0].reshape(35, 4), rows[0].reshape(10, 3),
                                               vals[0, :10, :3].contiguous())
    with pytest.raises(ValueError, match="expected cuda"):
        ell_sparse_pool.sparse_pool_ell_kernel(src.reshape(2, 35, 4), rows.reshape(2, 10, 3),
                                               vals[:, :10, :3].contiguous())
    with pytest.raises(ValueError, match="expected cuda"):
        crop_resize.crop_and_resize_group_kernel(src, torch.rand(2, 3, 4, 4), (3, 3), 4)


def _bwd_launches():
    return (sparse_pool.sparse_pool_patch_bwd_kernel.launches,
            crop_resize.crop_and_resize_group_bwd_kernel.launches)


def test_cpu_backward_takes_the_plain_twins_and_launches_nothing():
    before = _bwd_launches()
    src, rows, cols, vals = _small_inputs()
    x = src.clone().requires_grad_(True)
    g = torch.randn(2, 11, 4, generator=torch.Generator().manual_seed(0))
    _, den = sparse_pool.sparse_pool_patch_plain(src, rows, cols, vals, 11, True)
    sparse_pool.sparse_pool_patch_major_batch(x, rows, cols, vals, 11, True).backward(g)
    torch.testing.assert_close(x.grad, sparse_pool.sparse_pool_patch_bwd_plain(
        g, rows, cols, vals, (5, 7), den))
    boxes = torch.rand(2, 3, 4, 4) * 5
    x = src.clone().requires_grad_(True)
    gc = torch.randn(2, 3, 4, 3, 3, 4, generator=torch.Generator().manual_seed(1))
    crop_resize.crop_and_resize_group_einsum_px(x, boxes, (3, 3), 4).backward(gc)
    torch.testing.assert_close(x.grad, crop_resize.crop_and_resize_group_bwd_plain(
        gc, boxes, src.shape, (3, 3), 4, torch.float32))
    assert _bwd_launches() == before


def test_gradients_of_the_coo_and_the_boxes_raise():
    """They no longer raise: kernel A's weights and the grouped crop's boxes
    take their gradients, equal to the plain forms the backwards call (the
    weights' against ``jax.vjp`` in ``tests/test_torch_options.py``)."""

    src, rows, cols, vals = _small_inputs()
    v = vals.clone().requires_grad_(True)
    g = torch.randn(2, 11, 4, generator=torch.Generator().manual_seed(3))
    out = sparse_pool.sparse_pool_patch_major_batch(src, rows, cols, v, 11, True)
    out.backward(g)
    _, den = sparse_pool.sparse_pool_patch_plain(src, rows, cols, vals, 11, True)
    want = sparse_pool.sparse_pool_patch_vals_grad(g, src, rows, cols, out.detach(), den)
    assert torch.equal(v.grad, want) and v.grad.abs().max() > 0
    boxes = (torch.rand(2, 3, 4, 4, generator=torch.Generator().manual_seed(4)) * 5).requires_grad_(True)
    gc = torch.randn(2, 3, 4, 3, 3, 4, generator=torch.Generator().manual_seed(5))
    crop_resize.crop_and_resize_group_einsum_px(src, boxes, (3, 3), 4).backward(gc)
    want = crop_resize.bilinear_box_grad(
        gc.reshape(2, 12, 3, 3, 4), src, boxes.detach().reshape(2, 12, 4),
        lambda bx: crop_resize._group_coords(bx.reshape(2, 3, 4, 4), 5, 7, (3, 3), 4),
    ).reshape(2, 3, 4, 4)
    assert torch.equal(boxes.grad, want) and boxes.grad.abs().max() > 0


def test_exact_crop_boxes_take_a_gradient():
    """The rcnn family's proposals keep their gradient into the exact crop;
    ``test_torch_rcnn.py`` holds its value against ``jax.vjp``."""

    src, _, _, _ = _small_inputs()
    boxes_px = (torch.rand(2, 3, 4, generator=torch.Generator().manual_seed(2)) * 5).requires_grad_(True)
    crop_resize.crop_and_resize_px_batch(src, boxes_px, (3, 3)).sum().backward()
    assert torch.isfinite(boxes_px.grad).all() and boxes_px.grad.abs().max() > 0


def test_backward_wrappers_refuse_cpu_tensors():
    src, rows, cols, vals = _small_inputs()
    with pytest.raises(ValueError, match="expected cuda"):
        sparse_pool.sparse_pool_patch_bwd_kernel(torch.rand(2, 11, 4), rows, cols, vals, (5, 7))
    with pytest.raises(ValueError, match="expected cuda"):
        crop_resize.crop_and_resize_group_bwd_kernel(torch.rand(2, 3, 4, 3, 3, 4), torch.rand(2, 3, 4, 4),
                                                     src.shape, (3, 3), 4, torch.float32)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()
    for name in kernels.KERNEL_SOURCES:
        assert (kernels.CSRC / f"{name}.cu").exists()
    assert kernels._lib_path("group_crop").parent == REPO / "build" / "torch_kernels"


# ------------------------------------------------------------ on the card
# Marked ``cuda`` (registered in pytest.ini); the fixture skips them without a
# card. On the card: ``python3 -m pytest --noconftest -m cuda tests/test_torch_port.py``.


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-5)])
@pytest.mark.parametrize("divide", [True, False])
def test_kernel_a_matches_plain_on_card(cuda, dtype, atol, divide):
    """f32 accumulation either way; atomics reorder the sums (f32 rounding)."""

    src, rows, cols, vals = (t.to(cuda) for t in _small_inputs(1))
    src = src.to(dtype)
    got, got_den = sparse_pool.sparse_pool_patch_kernel(src, rows, cols, vals, 11, divide)
    want, want_den = sparse_pool.sparse_pool_patch_plain(src, rows, cols, vals, 11, divide)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=atol, rtol=1e-5)
    assert (got_den is None) == (want_den is None) == (not divide)
    if divide:
        torch.testing.assert_close(got_den, want_den, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_kernel_b_matches_plain_on_card(cuda, dtype, atol):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(300, 16, generator=g).to(dtype).to(cuda)
    idx = torch.randint(0, 300, (77, 8), generator=g, dtype=torch.int32).to(cuda)
    w = torch.rand(77, 8, generator=g).to(cuda)
    got = ell_sparse_pool.sparse_pool_ell_kernel(x[None], idx[None], w[None])[0]
    want = sparse_pool.sparse_pool_ell(x, idx, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 5e-2)])
def test_kernel_c_matches_plain_on_card(cuda, dtype, atol):
    """bf16: the twin rounds after each of its two products, the kernel once."""

    g = torch.Generator().manual_seed(1)
    img = torch.randn(2, 16, 20, 8, generator=g).to(dtype).to(cuda)
    c = torch.rand(2, 6, 1, 2, generator=g) * torch.tensor([16.0, 20.0])
    half = torch.rand(2, 6, 8, 2, generator=g) * 3
    boxes = torch.cat([c - half, c + half], -1).contiguous().to(cuda)
    got = crop_resize.crop_and_resize_group_kernel(img, boxes, (3, 3), 10)
    want = crop_resize.crop_and_resize_group_plain(img, boxes, (3, 3), 10)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
def test_forward_on_card_counts_kernel_launches(cuda):
    cfg = cars_pyramid_config().model
    cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, channels=(8, 8, 8, 16), out_channels=8),
        avod=dataclasses.replace(cfg.avod, fc_layers=(64,)),
    )
    model = pl.make_model(cfg, device=cuda)
    frames = [synthetic_frame(cfg, 4096, s, image="noise") for s in range(2)]
    batch = pl.stack_frames(frames, device=cuda)
    anchors = pl.static_anchor_grid(cfg, AreaExtents(), device=cuda)
    a0 = sparse_pool.sparse_pool_patch_kernel.launches
    c0 = crop_resize.crop_and_resize_group_kernel.launches
    det = pl.decode_batch(pl.forward_batch_fn(model, batch, anchors, cfg, AreaExtents()),
                          batch.ground_plane, cfg, AreaExtents())
    assert sparse_pool.sparse_pool_patch_kernel.launches - a0 == 2
    assert crop_resize.crop_and_resize_group_kernel.launches - c0 == 2
    assert torch.isfinite(det["boxes_3d"]).all()


@pytest.mark.cuda
def test_train_step_on_card_counts_backward_launches(cuda):
    """One training step of a thin cars model: 2 launches each of A, C,
    A-bwd and C-bwd (both fusion directions, both RPN views)."""

    from sparse_pooling_tpu_torch.runtime import trainer as tr

    cfg = cars_pyramid_config()
    model_cfg = dataclasses.replace(
        cfg.model, backbone=dataclasses.replace(cfg.model.backbone, channels=(8, 8, 8, 16), out_channels=8),
        avod=dataclasses.replace(cfg.model.avod, fc_layers=(64,)),
        rpn=dataclasses.replace(cfg.model.rpn, train_nms_size=64),
    )
    cfg = dataclasses.replace(cfg, model=model_cfg)
    model = pl.make_model(model_cfg, device=cuda).float()
    opt, sched = tr.build_optimizer(model.parameters(), cfg)
    anchors = pl.static_anchor_grid(model_cfg, AreaExtents(), device=cuda)
    step = tr.make_train_step(model, opt, sched, anchors, cfg, AreaExtents())
    batch = pl.stack_frames([synthetic_frame(model_cfg, 4096, s, image="noise") for s in range(2)], device=cuda)
    kernels_ = (sparse_pool.sparse_pool_patch_kernel, crop_resize.crop_and_resize_group_kernel,
                sparse_pool.sparse_pool_patch_bwd_kernel, crop_resize.crop_and_resize_group_bwd_kernel)
    before = [k.launches for k in kernels_]
    metrics = step(batch, torch.Generator(device=cuda).manual_seed(0))
    assert [k.launches - b for k, b in zip(kernels_, before)] == [2, 2, 2, 2]
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(torch.isfinite(p).all() for p in model.parameters())



@pytest.mark.cuda
def test_rcnn_on_card_counts_kernel_launches(cuda):
    """A thin rcnn model: a request launches A twice and C never (dense RPN);
    a training step adds A-bwd twice and no C-bwd."""

    from sparse_pooling_tpu_torch.runtime import trainer as tr

    cfg = rcnn_cars_config()
    model_cfg = dataclasses.replace(
        cfg.model, backbone=dataclasses.replace(cfg.model.backbone, channels=(8, 8, 8, 16), out_channels=8),
        avod=dataclasses.replace(cfg.model.avod, fc_layers=(64,)),
        rpn=dataclasses.replace(cfg.model.rpn, fusion_channels=16, train_nms_size=64, eval_nms_size=64),
    )
    cfg = dataclasses.replace(cfg, model=model_cfg)
    model = pl.make_model(model_cfg, device=cuda).float()
    anchors = pl.static_anchor_grid(model_cfg, AreaExtents(), device=cuda)
    batch = pl.stack_frames([synthetic_frame(model_cfg, 4096, s, image="noise") for s in range(2)], device=cuda)
    kernels_ = (sparse_pool.sparse_pool_patch_kernel, crop_resize.crop_and_resize_group_kernel,
                sparse_pool.sparse_pool_patch_bwd_kernel, crop_resize.crop_and_resize_group_bwd_kernel)
    before = [k.launches for k in kernels_]
    det = pl.decode_batch(pl.forward_batch_fn(model, batch, anchors, model_cfg, AreaExtents()),
                          batch.ground_plane, model_cfg, AreaExtents())
    assert [k.launches - b for k, b in zip(kernels_, before)] == [2, 0, 0, 0]
    assert torch.isfinite(det["boxes_3d"]).all()
    opt, sched = tr.build_optimizer(model.parameters(), cfg)
    step = tr.make_train_step(model, opt, sched, anchors, cfg, AreaExtents())
    before = [k.launches for k in kernels_]
    metrics = step(batch, torch.Generator(device=cuda).manual_seed(0))
    assert [k.launches - b for k, b in zip(kernels_, before)] == [2, 0, 2, 0]
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.cuda
def test_prefetcher_on_card_pins_and_waits(cuda, tmp_path):
    """KittiDataset batches of a written tree through DevicePrefetcher: every
    array lands on the card equal to the host batch, from pinned buffers,
    the consumer reading on a stream of its own behind the copies' events."""

    from sparse_pooling_tpu_torch.data.dataset import KittiDataset
    from sparse_pooling_tpu_torch.data.prefetch import DevicePrefetcher
    from sparse_pooling_tpu_torch.data.synthetic import write_kitti_tree

    write_kitti_tree(str(tmp_path), num_frames=7, n_ground=4000, n_obj=200, val_frames=(6,))
    cfg = cars_pyramid_config()
    sp = dataclasses.replace(cfg.model.sparse_pool, max_points=8192, point_buckets=(2048, 4096))
    model = dataclasses.replace(cfg.model, sparse_pool=sp)
    ds = KittiDataset(dataclasses.replace(cfg.dataset, root=str(tmp_path)), model, AreaExtents())
    want = list(ds.batches(2, 0))
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        with DevicePrefetcher(ds.batches(2, 0), depth=2, device=cuda) as pf:
            got = [(tuple(t.clone() if t is not None else None for t in ts), ids) for ts, ids in pf]
            pinned = [b for slot in pf._slots for b in slot["bufs"].values()]
        side.synchronize()
    assert len(got) == len(want) == 3
    assert pinned and all(b.is_pinned() for b in pinned)
    assert pf.timings["put"] > 0
    for (tensors, ids), (arrays, want_ids) in zip(got, want):
        assert ids == want_ids
        for t, a in zip(tensors, arrays):
            assert t.is_cuda and t.dtype == torch.from_numpy(a).dtype
            assert np.array_equal(t.cpu().numpy(), a)


@pytest.mark.cuda
def test_evaluator_on_card_matches_cpu(cuda, tmp_path):
    """``Evaluator.run_checkpoint_once`` on the card and on the CPU, same
    weights, a thin f32 config over a written tree (three val frames at
    batch 2, the tail padded): A and C launch twice a batch on the card, the
    same files and rows, numbers within 1e-3 px (2D box) and 1e-4 (3D box,
    score), AP within 1e-6."""

    from sparse_pooling_tpu_torch import weights
    from sparse_pooling_tpu_torch.data.synthetic import write_kitti_tree
    from sparse_pooling_tpu_torch.runtime.evaluator import Evaluator

    root = tmp_path / "tree"
    write_kitti_tree(str(root), num_frames=5, n_ground=6000, n_obj=300, val_frames=(2, 3, 4))
    cfg = cars_pyramid_config()
    m, r = cfg.model, dataclasses.replace
    model_cfg = r(
        m,
        sparse_pool=r(m.sparse_pool, max_points=1024, point_buckets=(512,), pool_channels=4),
        anchors=r(m.anchors, max_anchors=256),
        backbone=r(m.backbone, channels=(4, 4, 4, 4), blocks=(1, 1, 1, 1), out_channels=4,
                   compute_dtype="float32"),
        rpn=r(m.rpn, roi_channels=4, fusion_channels=8, pre_nms_top_k=128, eval_nms_size=16),
        avod=r(m.avod, fc_layers=(16,), nms_size=8),
    )
    cfg = r(cfg, model=model_cfg, dataset=r(cfg.dataset, root=str(root), split="val"),
            eval=r(cfg.eval, batch_size=2, kitti_score_threshold=0.0))
    ext = AreaExtents(x_min=-20.0, x_max=20.0, z_min=0.0, z_max=39.6)
    init = pl.make_model(model_cfg, ext, device="cpu")
    weights.init_like_flax(init, seed=0)
    rows, results = {}, {}
    for dev in ("cuda", "cpu"):
        ev = Evaluator(cfg, extents=ext, workdir=str(tmp_path / dev), device=dev)
        sparse_pool.sparse_pool_patch_kernel.launches = crop_resize.crop_and_resize_group_kernel.launches = 0
        results[dev] = ev.run_checkpoint_once(1, state_dict=init.state_dict())
        assert sparse_pool.sparse_pool_patch_kernel.launches == crop_resize.crop_and_resize_group_kernel.launches \
            == (4 if dev == "cuda" else 0)
        pred_dir = tmp_path / dev / "predictions" / "kitti_native_eval" / "0" / "1" / "data"
        rows[dev] = {p.name: [line.split() for line in p.read_text().splitlines()]
                     for p in sorted(pred_dir.glob("*.txt"))}
    assert list(rows["cuda"]) == list(rows["cpu"]) == ["000002.txt", "000003.txt", "000004.txt"]
    assert sum(len(v) for v in rows["cpu"].values()) > 0
    for name, want in rows["cpu"].items():
        got = rows["cuda"][name]
        assert [g[0] for g in got] == [w[0] for w in want], name
        g = np.array([[float(v) for v in row[3:]] for row in got]).reshape(-1, 13)
        w = np.array([[float(v) for v in row[3:]] for row in want]).reshape(-1, 13)
        np.testing.assert_allclose(g[:, 1:5], w[:, 1:5], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g[:, [0, *range(5, 13)]], w[:, [0, *range(5, 13)]], atol=1e-4, rtol=0)
    for cls, metrics in results["cpu"]["ap"].items():
        for metric, diffs in metrics.items():
            for d, v in diffs.items():
                assert abs(results["cuda"]["ap"][cls][metric][d] - v) <= 1e-6, (cls, metric, d)


@pytest.mark.cuda
def test_operators_launch_the_kernels_on_card(cuda):
    """Each ``torch.ops.spt`` operator on CUDA tensors launches its kernel
    once (counted by the launcher) and gives the raw launcher's bits; A
    without the division returns its weight sums as an empty tensor."""

    src, rows, cols, vals = (t.to(cuda) for t in _small_inputs(1))
    a0 = sparse_pool.sparse_pool_patch_kernel.launches
    out, den = torch.ops.spt.sparse_pool_patch(src, rows, cols, vals, 11, True, "float32")
    raw, raw_den = sparse_pool.sparse_pool_patch_kernel(src, rows, cols, vals, 11, True)
    assert sparse_pool.sparse_pool_patch_kernel.launches - a0 == 2
    assert torch.equal(out, raw) and torch.equal(den, raw_den)
    assert torch.ops.spt.sparse_pool_patch(src, rows, cols, vals, 11, False, "float32")[1].shape == (0,)
    g = torch.randn(2, 11, 4, generator=torch.Generator().manual_seed(2)).to(cuda)
    b0 = sparse_pool.sparse_pool_patch_bwd_kernel.launches
    got = torch.ops.spt.sparse_pool_patch_bwd(g, rows, cols, vals, 5, 7, den, torch.float32)
    assert sparse_pool.sparse_pool_patch_bwd_kernel.launches - b0 == 1
    assert torch.equal(got, sparse_pool.sparse_pool_patch_bwd_kernel(g, rows, cols, vals, (5, 7), den))
    x, idx, w = src.reshape(2, 35, 4), rows.reshape(2, 10, 3), vals[:, :10, :3].contiguous()
    e0 = ell_sparse_pool.sparse_pool_ell_kernel.launches
    got = torch.ops.spt.ell_sparse_pool(x, idx, w)
    assert ell_sparse_pool.sparse_pool_ell_kernel.launches - e0 == 1
    assert torch.equal(got, ell_sparse_pool.sparse_pool_ell_kernel(x, idx, w))
    gen = torch.Generator().manual_seed(1)
    img = torch.randn(2, 16, 20, 8, generator=gen).to(cuda)
    c = torch.rand(2, 6, 1, 2, generator=gen) * torch.tensor([16.0, 20.0])
    half = torch.rand(2, 6, 8, 2, generator=gen) * 3
    boxes = torch.cat([c - half, c + half], -1).contiguous().to(cuda)
    c0 = crop_resize.crop_and_resize_group_kernel.launches
    got = torch.ops.spt.group_crop(img, boxes, 3, 3, 10)
    assert crop_resize.crop_and_resize_group_kernel.launches - c0 == 1
    assert torch.equal(got, crop_resize.crop_and_resize_group_kernel(img, boxes, (3, 3), 10))
    grad = torch.randn(2, 6, 8, 3, 3, 8, generator=gen).to(cuda)
    d0 = crop_resize.crop_and_resize_group_bwd_kernel.launches
    got = torch.ops.spt.group_crop_bwd(grad, boxes, 16, 20, 3, 3, 10, torch.float32)
    assert crop_resize.crop_and_resize_group_bwd_kernel.launches - d0 == 1
    assert torch.equal(got, crop_resize.crop_and_resize_group_bwd_kernel(
        grad, boxes, (2, 16, 20, 8), (3, 3), 10, torch.float32))


@pytest.mark.cuda
def test_exported_program_launches_the_kernels_on_card(cuda, tmp_path):
    """A thin cars model exported on the card, saved and loaded: its
    detections within 1e-5 of the live pipeline's, A and C launched twice a
    request from the loaded program; a CPU batch is refused."""

    from sparse_pooling_tpu_torch.data.dataset import MAX_GT_BOXES
    from sparse_pooling_tpu_torch.runtime import export as export_mod

    pcfg = cars_pyramid_config()
    cfg = dataclasses.replace(
        pcfg.model, backbone=dataclasses.replace(pcfg.model.backbone, channels=(8, 8, 8, 16), out_channels=8),
        avod=dataclasses.replace(pcfg.model.avod, fc_layers=(64,)),
    )
    pcfg = dataclasses.replace(pcfg, model=cfg)
    model = pl.make_model(cfg, device=cuda)
    batch = pl.stack_frames([synthetic_frame(cfg, 4096, s, image="noise") for s in range(2)], device=cuda)

    def pad(t, n):
        return torch.cat([t, t.new_zeros((t.shape[0], n - t.shape[1]) + t.shape[2:])], 1)

    p_max = cfg.sparse_pool.max_points
    batch = batch._replace(points=pad(batch.points, p_max), points_mask=pad(batch.points_mask, p_max),
                           gt_boxes_3d=pad(batch.gt_boxes_3d, MAX_GT_BOXES),
                           gt_valid=pad(batch.gt_valid, MAX_GT_BOXES), gt_classes=pad(batch.gt_classes, MAX_GT_BOXES))
    anchors = pl.static_anchor_grid(cfg, AreaExtents(), device=cuda)
    want = pl.decode_batch(pl.forward_batch_fn(model, batch, anchors, cfg, AreaExtents()),
                           batch.ground_plane, cfg, AreaExtents())
    path = str(tmp_path / "thin_b2.pt2")
    export_mod.save_exported(export_mod.export_inference(pcfg, model, batch_size=2, device=cuda), path)
    fn = export_mod.load_serving_fn(path)
    assert fn.device_type == "cuda"
    a0 = sparse_pool.sparse_pool_patch_kernel.launches
    c0 = crop_resize.crop_and_resize_group_kernel.launches
    got = fn(batch)
    assert sparse_pool.sparse_pool_patch_kernel.launches - a0 == 2
    assert crop_resize.crop_and_resize_group_kernel.launches - c0 == 2
    assert torch.equal(got["valid"], want["valid"])
    for k in ("boxes_3d", "scores"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="exported for cuda"):
        fn(pl.RawSample(*(t.cpu() for t in batch)))
