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
    torch.testing.assert_close(out, sparse_pool.sparse_pool_patch_plain(src, rows, cols, vals, 11, True))
    idx = rows[0].reshape(10, 3)
    w = vals[0, :10, :3].contiguous()
    x = src[0].reshape(35, 4)
    torch.testing.assert_close(ell_sparse_pool.sparse_pool_fused(x, idx, w), sparse_pool.sparse_pool_ell(x, idx, w))
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
        crop_resize.crop_and_resize_group_kernel(src, torch.rand(2, 3, 4, 4), (3, 3), 4)


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
    got = sparse_pool.sparse_pool_patch_kernel(src, rows, cols, vals, 11, divide)
    want = sparse_pool.sparse_pool_patch_plain(src, rows, cols, vals, 11, divide)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=atol, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_kernel_b_matches_plain_on_card(cuda, dtype, atol):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(300, 16, generator=g).to(dtype).to(cuda)
    idx = torch.randint(0, 300, (77, 8), generator=g, dtype=torch.int32).to(cuda)
    w = torch.rand(77, 8, generator=g).to(cuda)
    got = ell_sparse_pool.sparse_pool_ell_kernel(x, idx, w)
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

