"""The port's seeded init (``weights.init_like_flax``), on the CPU.

* it does not depend on how the installed PyTorch samples
  ``nn.init.trunc_normal_``: PyTorch 2.13 samples by rejection where
  earlier versions (and ``jax.random.truncated_normal``) take the inverse
  CDF of one uniform draw, so the same seed gave other initial weights on
  another PyTorch. The init must give the same weights under either
  sampler, and a pinned digest of its weights for seed 0;
* its kernels have flax's ``lecun_normal`` distribution: the standard
  deviation, the truncation bound and the quantiles of flax's own draws at
  the same shape.
"""

import dataclasses
import hashlib
import math

import numpy as np
import pytest
import torch
from torch import nn

from sparse_pooling_tpu_torch import weights
from sparse_pooling_tpu_torch.configs import unittest_config
from sparse_pooling_tpu_torch.experiments import people_check
from sparse_pooling_tpu_torch.models import pipeline as pl


def _inverse_cdf(tensor, mean, std, a, b, generator=None):
    """``nn.init.trunc_normal_`` as PyTorch sampled it before 2.13."""

    def cdf(x):
        return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0

    with torch.no_grad():
        lo, hi = cdf((a - mean) / std), cdf((b - mean) / std)
        tensor.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
        tensor.erfinv_().mul_(std * math.sqrt(2.0)).add_(mean).clamp_(min=a, max=b)
    return tensor


def _rejection(tensor, mean, std, a, b, generator=None):
    """``nn.init.trunc_normal_`` as PyTorch 2.13 samples it: normal draws,
    those outside [a, b] drawn again."""

    with torch.no_grad():
        tensor.normal_(mean, std, generator=generator)
        while True:
            out = (tensor < a) | (tensor > b)
            if not bool(out.any()):
                return tensor
            tensor.copy_(torch.where(out, torch.empty_like(tensor).normal_(mean, std, generator=generator), tensor))


def _models():
    people = people_check.build_config(
        people_check.parse_args(["--train_frames", "4", "--val_frames", "2", "--device", "cpu"]), "unused", "unused")
    unit = unittest_config().model
    return {
        "unittest": unit,
        "people_check": people.model,
        "unittest_rcnn": dataclasses.replace(unit, architecture="rcnn"),
    }


def _digest(model) -> str:
    h = hashlib.sha256()
    for name, value in model.state_dict().items():
        h.update(name.encode())
        h.update(value.numpy().tobytes())
    return h.hexdigest()[:16]


# seed 0's weights: the inverse CDF of PyTorch's CPU uniform stream (PyTorch
# 2.11 and 2.13 give these bits)
PINNED = {"unittest": "e0219515f1eda0e9", "people_check": "c0455d1a15cfcdc9", "unittest_rcnn": "f1bde1fe7d216371"}


@pytest.mark.parametrize("name", sorted(_models()))
def test_init_like_flax_does_not_depend_on_trunc_normal(name, monkeypatch):
    cfg = _models()[name]
    runs = {}
    for sampler in (_inverse_cdf, _rejection):
        monkeypatch.setattr(nn.init, "trunc_normal_", sampler)
        model = pl.make_model(cfg, device="cpu").float()
        weights.init_like_flax(model, seed=0)
        runs[sampler.__name__] = _digest(model)
    assert runs["_inverse_cdf"] == runs["_rejection"], runs
    assert runs["_inverse_cdf"] == PINNED[name]


@pytest.mark.parametrize("shape", [(2048, 512), (32, 16, 3, 3)])
def test_init_like_flax_has_flax_lecun_normal_moments(shape):
    jax = pytest.importorskip("jax")
    flax_init = pytest.importorskip("flax.linen.initializers")
    layer = nn.Linear(shape[1], shape[0]) if len(shape) == 2 else nn.Conv2d(shape[1], shape[0], shape[2:])
    weights.init_like_flax(layer, seed=3)
    ours = layer.weight.detach().numpy().ravel()
    # flax's kernel layout: (in, out) or (kh, kw, in, out); fan_in is the same
    flax_shape = (shape[1], shape[0]) if len(shape) == 2 else (*shape[2:], shape[1], shape[0])
    theirs = np.asarray(flax_init.lecun_normal()(jax.random.PRNGKey(3), flax_shape)).ravel()
    fan_in = math.prod(shape[1:])
    scale = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # the draw's std before truncation
    assert np.abs(ours).max() <= 2 * scale * (1 + 1e-6)
    assert np.abs(theirs).max() <= 2 * scale * (1 + 1e-6)
    n = min(ours.size, theirs.size)
    tol = 6 * math.sqrt(1.0 / fan_in) / math.sqrt(n) * 2  # a few standard errors
    assert abs(ours.std() - math.sqrt(1.0 / fan_in)) < tol
    assert abs(ours.std() - theirs.std()) < tol
    assert abs(ours.mean()) < tol and abs(theirs.mean()) < tol
    q = [0.05, 0.25, 0.5, 0.75, 0.95]
    np.testing.assert_allclose(np.quantile(ours, q), np.quantile(theirs, q), atol=8 * scale / math.sqrt(n))
