"""The AVOD detector's stage-2 and backbone options, PyTorch port against
the JAX package on the CPU: strided stage-2 crops (one patch window a
proposal from the avg-pooled maps), the ``late`` and ``deep`` fusion types
and the ``concat`` combiner of the stage-2 head, and ``backbone.remat``.

Each option switches the narrow parity config as
``tests/test_torch_options_rpn.py`` does, with its tolerances: every forward
output to 1e-4 of its largest value, masks equal, the detections; one
training step's loss terms to 1e-4 and every parameter's gradient to 1e-4
of that parameter's largest (the late and deep layers ``fc{i}_v{vi}`` among
them, through ``weights.from_flax``). Remat also holds its own training step
against the same step without it, in one process, to 1e-6.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports flax

from sparse_pooling_tpu_torch import weights  # noqa: E402
from sparse_pooling_tpu_torch.models import pipeline as t_pl  # noqa: E402
from test_torch_options_rpn import (  # noqa: E402
    FLOAT_OUTPUTS,
    T_EXT,
    TERMS,
    both,
    check_detections,
    check_gradients,
    check_loss,
    check_masks,
    check_outputs,
    option_config,
    option_frames,
)

OPTIONS = {
    "strided_stage2": dict(avod=dict(bev_roi_stride=4, img_roi_stride=4)),
    "late": dict(avod=dict(fusion_type="late")),
    "deep": dict(avod=dict(fusion_type="deep")),
    "deep_concat": dict(avod=dict(fusion_type="deep", fusion_method="concat")),
    "early_concat": dict(avod=dict(fusion_method="concat")),
    "remat": dict(backbone=dict(remat=True)),
}
# the JAX init's seed per option: under seed 0, early_concat's fc3 meets one
# pre-activation 9e-12 from the ReLU's kink, where the two packages' f32
# sums fall on either side and the gradient of that unit passes in one and
# not in the other (8e-4 of the largest gradient in a few tensors)
INIT_SEED = {"early_concat": 1}


@pytest.fixture(scope="module", params=list(OPTIONS))
def option_run(request):
    return both(option_config(T_EXT, **OPTIONS[request.param]), T_EXT,
                init_seed=INIT_SEED.get(request.param, 0))


@pytest.mark.parametrize("key", FLOAT_OUTPUTS)
def test_forward_outputs_match_jax(option_run, key):
    check_outputs(option_run, key)


@pytest.mark.parametrize("key", ["anchor_valid", "proposal_valid"])
def test_forward_masks_match_jax(option_run, key):
    check_masks(option_run, key)


def test_detections_match_jax(option_run):
    check_detections(option_run)


@pytest.mark.parametrize("term", TERMS)
def test_train_step_losses_match_jax(option_run, term):
    check_loss(option_run, term)


def test_train_step_gradients_match_jax(option_run):
    check_gradients(option_run)


def test_stage2_head_layers(option_run):
    """The head's layers and widths per option: ``fc{i}`` for early fusion,
    ``fc{i}_v{vi}`` per view for late and deep; concat doubles the input of
    every layer that reads a combine, and of the output layers after late
    or deep."""

    cfg, head = option_run["cfg"], option_run["port"]["model"].stage2_head
    avod = cfg.avod
    widths = [7 * 7 * cfg.backbone.out_channels, *avod.fc_layers]
    mult = 2 if avod.fusion_method == "concat" else 1
    if avod.fusion_type == "early":
        assert [getattr(head, f"fc{i + 1}").in_features for i in range(3)] == [widths[0] * mult, *widths[1:3]]
        assert not hasattr(head, "fc1_v0") and head.cls.in_features == widths[-1]
    else:
        deep = avod.fusion_type == "deep"
        for i in range(3):
            for vi in range(2):
                assert getattr(head, f"fc{i + 1}_v{vi}").in_features == widths[i] * (mult if deep else 1)
        assert not hasattr(head, "fc1") and head.cls.in_features == widths[-1] * mult


def test_remat_step_equals_the_step_without_it():
    """The same weights, frames and sampling noise through one training step
    with and without ``backbone.remat``: losses and every gradient agree."""

    cfg = option_config(T_EXT)
    frames = option_frames(cfg, T_EXT)
    batch = t_pl.stack_frames(frames, device="cpu")
    g = torch.Generator().manual_seed(3)
    noise = (torch.rand((2, cfg.anchors.max_anchors), generator=g),
             torch.rand((2, cfg.rpn.train_nms_size), generator=g))
    runs = []
    for remat in (False, True):
        c = option_config(T_EXT, backbone=dict(remat=remat))
        model = t_pl.make_model(c, T_EXT, device="cpu").float()
        weights.init_like_flax(model, seed=0)
        assert model.bev_extractor.remat == remat
        out = t_pl.forward_batch_fn(model, batch, t_pl.static_anchor_grid(c, T_EXT, device="cpu"), c, T_EXT,
                                    train=True)
        losses = t_pl.loss_batch(out, batch, c, T_EXT, noise=noise)
        losses["total"].backward()
        runs.append(({k: v.item() for k, v in losses.items()},
                     {n: p.grad.clone() for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    for k in l0:
        np.testing.assert_allclose(l1[k], l0[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert g0.keys() == g1.keys() and l0["num_s2_pos"] > 0
    for n in g0:
        scale = max(g0[n].abs().max().item(), 1e-8)
        assert (g1[n] - g0[n]).abs().max().item() <= 1e-6 * scale, n
