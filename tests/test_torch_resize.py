"""The port's host bilinear resize (``data/pil_resize.py``) against Pillow's
``Image.resize(..., Image.BILINEAR)``, byte for byte, on the CPU.

The grid takes each axis up, down and unchanged, odd and tiny sizes (a side
of 1, a reduction by more than the image), and the KITTI raw size onto the
checks' canvases (48x160, 96x320) and the production one (384x1248); a
``hypothesis`` case draws sizes and pixels. The machine with the card has no
PIL: there this file skips.
"""

import numpy as np
import pytest

PIL_Image = pytest.importorskip("PIL.Image")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from sparse_pooling_tpu_torch.data.pil_resize import coefficients, resize_bilinear  # noqa: E402


def _pil(img: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.asarray(PIL_Image.fromarray(img).resize((w, h), PIL_Image.BILINEAR))


def _image(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    img[h // 3:, : w // 2] = 255  # saturated and black runs: the clamp at both ends
    img[: h // 4, w // 2:] = 0
    return img


@pytest.mark.parametrize("raw,out", [
    ((375, 1242), (48, 160)), ((375, 1242), (96, 320)), ((375, 1242), (384, 1248)),
    ((375, 1242), (375, 1242)), ((375, 1242), (375, 320)), ((375, 1242), (96, 1242)),
])
def test_kitti_sizes_match_pil(raw, out):
    img = _image(*raw, seed=sum(out))
    got = resize_bilinear(img, *out)
    assert got.shape == out + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil(img, *out))


@pytest.mark.parametrize("h_in,h_out", [(7, 3), (7, 7), (7, 13), (1, 5), (5, 1), (2, 9), (31, 4)])
@pytest.mark.parametrize("w_in,w_out", [(9, 4), (9, 9), (9, 20), (1, 3), (6, 1), (64, 63), (3, 250)])
def test_grid_of_sizes_matches_pil(h_in, h_out, w_in, w_out):
    img = _image(h_in, w_in, seed=h_in * 100 + w_in)
    np.testing.assert_array_equal(resize_bilinear(img, h_out, w_out), _pil(img, h_out, w_out))


@settings(max_examples=60, deadline=None, database=None)
@given(h_in=st.integers(1, 40), w_in=st.integers(1, 40), h_out=st.integers(1, 60),
       w_out=st.integers(1, 60), seed=st.integers(0, 2**31 - 1))
def test_drawn_sizes_match_pil(h_in, w_in, h_out, w_out, seed):
    img = np.random.RandomState(seed).randint(0, 256, (h_in, w_in, 3)).astype(np.uint8)
    np.testing.assert_array_equal(resize_bilinear(img, h_out, w_out), _pil(img, h_out, w_out))


def test_taps_are_pillows_fixed_point():
    """Each output's taps sum to 2^22 within their rounding, start inside the
    input and cover the scaled support."""

    for n_in, n_out in ((1242, 160), (375, 48), (10, 30), (1, 4)):
        xmin, count, taps = coefficients(n_in, n_out)
        assert (xmin >= 0).all() and (xmin + count <= n_in).all() and (count >= 1).all()
        sums = taps.sum(axis=1)
        assert (np.abs(sums - 2**22) <= taps.shape[1]).all()
        assert (taps[np.arange(taps.shape[1])[None, :] >= count[:, None]] == 0).all()


def test_refuses_what_it_does_not_take():
    with pytest.raises(TypeError, match="uint8"):
        resize_bilinear(np.zeros((4, 4, 3), np.float32), 2, 2)
    with pytest.raises(TypeError, match="uint8"):
        resize_bilinear(np.zeros((4, 4), np.uint8), 2, 2)
    img = _image(5, 6, 0)
    out = resize_bilinear(img, 5, 6)  # no axis changes: a copy, as PIL's
    np.testing.assert_array_equal(out, img)
    assert out is not img
