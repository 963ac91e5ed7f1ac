"""The port's family contract (``models.pipeline.FAMILIES``): every preset's
architecture resolves through the one table, an unknown one is named; a
served batch reaches the RPN's selection and the final NMS through
``models.detector``'s module-level names, which the benchmark's recorder
and its planted faults wrap; and no port module outside the table compares
an architecture."""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from sparse_pooling_tpu_torch.configs import AreaExtents, presets
from sparse_pooling_tpu_torch.data.synthetic_frame import synthetic_frame
from sparse_pooling_tpu_torch.models import detector
from sparse_pooling_tpu_torch.models import pipeline as pl
from sparse_pooling_tpu_torch.models.detector import Family
from test_torch_contfuse import frames as contfuse_frames
from test_torch_contfuse import small_config as contfuse_small_config
from test_torch_mv3d import frames as mv3d_frames
from test_torch_mv3d import small_config as mv3d_small_config

REPO = Path(__file__).resolve().parent.parent
EXT = AreaExtents()
PRESETS = {"avod": presets.cars_pyramid_config, "rcnn": presets.rcnn_cars_config,
           "mv3d": presets.mv3d_cars_config, "contfuse": presets.contfuse_cars_config}


def small(architecture):
    """The family at the small CPU sizes of its own tests: the unittest
    preset (with the rcnn family's offsets), MV3D's small config."""

    if architecture == "mv3d":
        return mv3d_small_config()
    if architecture == "contfuse":
        return contfuse_small_config()
    cfg = presets.unittest_config().model
    if architecture == "rcnn":
        cfg = dataclasses.replace(cfg, architecture="rcnn", avod=dataclasses.replace(cfg.avod, box_rep="offsets"))
    return cfg


def small_frames(cfg):
    if cfg.architecture == "mv3d":
        return mv3d_frames(cfg)
    if cfg.architecture == "contfuse":
        return contfuse_frames(cfg)
    return [synthetic_frame(cfg, 600, seed) for seed in (0, 1)]


@pytest.mark.parametrize("architecture", list(PRESETS))
def test_every_preset_resolves_through_the_table(architecture):
    cfg = PRESETS[architecture]().model
    assert cfg.architecture == architecture
    fam = pl.family(cfg)
    assert fam is pl.FAMILIES[architecture] and isinstance(fam, Family)
    model = pl.make_model(small(architecture), EXT, device="cpu")
    assert type(model) is fam.model


@pytest.mark.parametrize("entry", ["family", "make_model", "static_anchor_grid", "decode_batch"])
def test_an_unknown_architecture_is_named(entry):
    cfg = dataclasses.replace(presets.unittest_config().model, architecture="pointpillars")
    calls = {
        "family": lambda: pl.family(cfg),
        "make_model": lambda: pl.make_model(cfg, EXT, device="cpu"),
        "static_anchor_grid": lambda: pl.static_anchor_grid(cfg, EXT, device="cpu"),
        "decode_batch": lambda: pl.decode_batch({}, torch.zeros(1, 4), cfg, EXT),
    }
    with pytest.raises(ValueError, match="architecture"):
        calls[entry]()


@pytest.mark.parametrize("architecture", list(PRESETS))
def test_a_served_batch_selects_through_the_shared_module(architecture, monkeypatch):
    """One RPN selection (none in the one-stage ContFuse) and
    ``num_classes`` final NMS calls a batch, each through
    ``models.detector``'s module-level name, looked up at the call."""

    cfg = small(architecture)
    model = pl.make_model(cfg, EXT, device="cpu")
    anchors = pl.static_anchor_grid(cfg, EXT, device="cpu")
    batch = pl.stack_frames(small_frames(cfg), device="cpu")
    calls = {"top_k_nms_batch": 0, "nms_batch": 0}

    def counted(name):
        inner = getattr(detector, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return inner(*args, **kwargs)

        monkeypatch.setattr(detector, name, call)

    counted("top_k_nms_batch")
    counted("nms_batch")
    out = pl.forward_batch_fn(model, batch, anchors, cfg, EXT)
    det = pl.decode_batch(out, batch.ground_plane, cfg, EXT)
    assert calls == {"top_k_nms_batch": int(architecture != "contfuse"), "nms_batch": cfg.num_classes}
    assert det["boxes_3d"].shape[:2] == (2, cfg.num_classes)
    assert out["anchor_valid"].shape == out["anchors"].shape[:2]


def _architecture_compares(path: Path):
    """The comparisons in ``path`` with an operand that names ``architecture``."""

    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Compare):
            operands = [node.left, *node.comparators]
            if any("architecture" in ast.unparse(o) for o in operands):
                found.append(f"{path.relative_to(REPO)}:{node.lineno}: {ast.unparse(node)}")
    return found


def test_no_port_module_outside_the_table_compares_the_architecture():
    files = sorted((REPO / "sparse_pooling_tpu_torch").rglob("*.py"))
    assert len(files) > 20
    table = REPO / "sparse_pooling_tpu_torch" / "models" / "pipeline.py"
    outside = [hit for path in files if path != table for hit in _architecture_compares(path)]
    assert not outside, outside
    assert [hit.split(": ", 1)[1] for hit in _architecture_compares(table)] == [
        "cfg.architecture not in FAMILIES"]
