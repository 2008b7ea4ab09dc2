"""The port's host-side utils -- run-length encoding, box matching and
visualization -- against the JAX package's, bit for bit, on the same
seeded inputs.  They are numpy, scipy and matplotlib code, copied; these
tests hold the copies to the originals (figures render under Agg)."""

import numpy as np
import pytest

from pytorch_toolbelt_tpu.utils import bboxes_utils as jbboxes
from pytorch_toolbelt_tpu.utils import rle as jrle
from pytorch_toolbelt_tpu.utils import visualization as jvis
from pytorch_toolbelt_tpu_torch import utils as tutils
from pytorch_toolbelt_tpu_torch.utils import bboxes_utils as tbboxes
from pytorch_toolbelt_tpu_torch.utils import rle as trle
from pytorch_toolbelt_tpu_torch.utils import visualization as tvis

# ---------------------------------------------------------------------------
# RLE
# ---------------------------------------------------------------------------


def _masks():
    rng = np.random.RandomState(0)
    blobs = (rng.rand(17, 23) > 0.6).astype(np.uint8)
    corners = np.zeros((8, 5), np.uint8)
    corners[0, 0] = corners[-1, -1] = 1  # runs at the first and the last pixel
    full = np.ones((4, 6), np.uint8)
    single = np.zeros((5, 5), np.uint8)
    single[2, 3] = 1
    return {"blobs": blobs, "corners": corners, "full": full, "single": single}


@pytest.mark.parametrize("name", list(_masks()))
def test_rle_encode_decode_equal_the_jax_package(name):
    mask = _masks()[name]
    want = jrle.rle_encode(mask)
    got = trle.rle_encode(mask)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    text = trle.rle_to_string(got)
    assert text == jrle.rle_to_string(want)
    decoded = trle.rle_decode(text, mask.shape)
    np.testing.assert_array_equal(decoded, jrle.rle_decode(text, mask.shape))
    np.testing.assert_array_equal(decoded, mask)
    assert tutils.rle_encode is trle.rle_encode


# ---------------------------------------------------------------------------
# Box matching
# ---------------------------------------------------------------------------


def _boxes(rng, n):
    xy = rng.rand(n, 2) * 80
    wh = 5 + rng.rand(n, 2) * 30
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _case(seed, n_pred, n_true, classes=4):
    rng = np.random.RandomState(seed)
    true_boxes = _boxes(rng, n_true)
    # half the predictions jitter a true box, the rest are anywhere
    jitter = true_boxes[rng.randint(0, max(n_true, 1), size=n_pred // 2)] + rng.randn(n_pred // 2, 4) * 2 \
        if n_true else np.zeros((0, 4))
    pred_boxes = np.concatenate([jitter, _boxes(rng, n_pred - len(jitter))]).astype(np.float32)
    return dict(pred_boxes=pred_boxes, pred_labels=rng.randint(0, classes, n_pred),
                pred_scores=rng.rand(n_pred).astype(np.float32), true_boxes=true_boxes,
                true_labels=rng.randint(0, classes, n_true), num_classes=classes)


def _assert_same_result(got, want):
    assert type(got).__name__ == "BBoxesMatchResult"
    assert got._fields == want._fields
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype and g.shape == w.shape


_CASES = {"many": (1, 12, 9), "few": (2, 3, 4), "no-predictions": (3, 0, 5), "no-truths": (4, 6, 0), "empty": (5, 0, 0)}


@pytest.mark.parametrize("threshold", [0.3, 0.5])
@pytest.mark.parametrize("name", list(_CASES))
def test_match_bboxes_equal_the_jax_package(name, threshold):
    case = _case(*_CASES[name])
    _assert_same_result(tbboxes.match_bboxes(**case, iou_threshold=threshold),
                        jbboxes.match_bboxes(**case, iou_threshold=threshold))
    case.pop("pred_scores")
    _assert_same_result(tbboxes.match_bboxes_hungarian(**case, iou_threshold=threshold),
                        jbboxes.match_bboxes_hungarian(**case, iou_threshold=threshold))


def test_box_iou_and_degenerate_boxes_equal_the_jax_package():
    """Zero-area boxes (union 0 against each other) give IoU 0 in both."""
    a = np.array([[0, 0, 10, 10], [5, 5, 5, 5], [2, 2, 8, 4]], np.float64)
    b = np.array([[5, 5, 5, 5], [0, 0, 10, 10], [20, 20, 30, 30]], np.float64)
    np.testing.assert_array_equal(tbboxes.box_iou(a, b), jbboxes.box_iou(a, b))
    case = dict(pred_boxes=a, pred_labels=np.array([0, 1, 2]), pred_scores=np.array([0.5, 0.9, 0.1]),
                true_boxes=b, true_labels=np.array([0, 1, 1]), num_classes=3)
    _assert_same_result(tbboxes.match_bboxes(**case), jbboxes.match_bboxes(**case))


def test_match_bboxes_raise_on_inconsistent_lengths():
    case = _case(6, 4, 3)
    case["pred_scores"] = case["pred_scores"][:2]
    for module in (tbboxes, jbboxes):
        with pytest.raises(ValueError, match="Inconsistent lengths"):
            module.match_bboxes(**case)
    case.pop("pred_scores")
    case["true_labels"] = case["true_labels"][:1]
    for module in (tbboxes, jbboxes):
        with pytest.raises(ValueError, match="Inconsistent lengths"):
            module.match_bboxes_hungarian(**case)


# ---------------------------------------------------------------------------
# Visualization
# ---------------------------------------------------------------------------


def _images(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, size=(h, w, 3)).astype(np.uint8) for h, w in [(10, 12), (7, 9), (13, 5), (4, 4)]]


@pytest.mark.parametrize("pad_value", [0, 127])
def test_stacking_equals_the_jax_package(pad_value):
    images = _images(7)
    for name, args in [("hstack_autopad", (images,)), ("vstack_autopad", (images,)), ("grid_stack", (images, 2, 2)),
                       ("grid_stack", (images[:3], 2, 2))]:
        want = getattr(jvis, name)(*args, pad_value=pad_value)
        got = getattr(tvis, name)(*args, pad_value=pad_value)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    with pytest.raises(ValueError):
        tvis.grid_stack(images, 1, 2)


def test_vstack_header_equals_the_jax_package():
    image = _images(8)[0]
    np.testing.assert_array_equal(tvis.vstack_header(image, "title", size=20),
                                  jvis.vstack_header(image, "title", size=20))
    gray = image[..., 0]
    np.testing.assert_array_equal(tvis.vstack_header(gray, "gray"), jvis.vstack_header(gray, "gray"))


@pytest.mark.parametrize("kind", ["confusion", "confusion-normalized", "compressed", "heatmap-float"])
def test_rendered_figures_equal_the_jax_package(kind):
    rng = np.random.RandomState(9)
    cm = rng.randint(0, 20, size=(3, 3))
    heat = rng.rand(2, 4)
    arrays = []
    for vis in (jvis, tvis):
        if kind.startswith("confusion"):
            fig = vis.plot_confusion_matrix(cm, ["a", "b", "c"], figsize=(3, 3), normalize=kind.endswith("normalized"),
                                            noshow=True)
        elif kind == "compressed":
            fig = vis.plot_compressed_confusion_matrix(cm, figsize=(3, 3), noshow=True)
        else:
            fig = vis.plot_heatmap(heat, "heat", figsize=(3, 3), noshow=True, cmap="viridis")
        arrays.append(vis.render_figure_to_tensor(fig))
    want, got = arrays
    assert got.ndim == 3 and got.shape[-1] == 3 and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
