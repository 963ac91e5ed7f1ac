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
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame
from sparse_pooling_tpu_torch.models import pipeline as pl
from sparse_pooling_tpu_torch.ops import crop_resize, ell_sparse_pool, sparse_pool

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "sparse_pooling_tpu", "__graft_entry__")


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


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["make_model", "static_anchor_grid", "stack_frames"])
def test_entry_points_raise_without_cuda_unless_cpu(no_cuda, entry):
    cfg = cars_pyramid_config().model
    calls = {
        "make_model": lambda dev: pl.make_model(cfg, device=dev),
        "static_anchor_grid": lambda dev: pl.static_anchor_grid(cfg, AreaExtents(), device=dev),
        "stack_frames": lambda dev: pl.stack_frames([synthetic_frame(cfg, 64, 0)], device=dev),
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
    src, rows, cols, vals = _small_inputs()
    with pytest.raises(NotImplementedError, match="vals"):
        sparse_pool.sparse_pool_patch_major_batch(src, rows, cols, vals.requires_grad_(True), 11, True)
    boxes = (torch.rand(2, 3, 4, 4) * 5).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="boxes"):
        crop_resize.crop_and_resize_group_einsum_px(src, boxes, (3, 3), 4)
    with pytest.raises(NotImplementedError, match="boxes"):
        crop_resize.crop_and_resize_px_batch(src, boxes[:, :, 0], (3, 3))


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

