"""Binary morphology and connected components.

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/morphology.py``, in its two
tiers:

* on tensors, on their device: :func:`binary_dilation`,
  :func:`binary_erosion` and :func:`binary_closing` with a disk structuring
  element, as a max / min over the element's shifts;
* on the host, through the port's binding of the repository's C++ kernels
  (``native.py``): small-object removal, the ROI labels and the region
  centroids of the region-query mode (utils.py:250-301), whose object
  counts vary and feed a loop over query points.

skimage's semantics: disk(r) = {(y, x): y^2 + x^2 <= r^2}; 8-connectivity
(connectivity=2) for labelling; closing erodes with out-of-image pixels
read as foreground, so borders do not erode. The ``*_plain`` functions are
the scipy versions (the JAX package's fallbacks): the plain twins the tests
hold the native path against; nothing on the port's path calls them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native


def disk(radius: int) -> np.ndarray:
    yy, xx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    return (yy * yy + xx * xx <= radius * radius).astype(bool)


# ---------------------------------------------------------------------------
# On tensors
# ---------------------------------------------------------------------------


def _morph_window(x, structure, dilate: bool):
    """out(p) = max (dilate) or min over {x[p + s] : s in structure} of the
    (H, W) mask x, out of the image 0 for dilation and 1 for erosion."""
    structure = np.asarray(structure, bool)
    r = structure.shape[0] // 2
    padded = torch.nn.functional.pad(x.float()[None], (r, r, r, r),
                                     value=0.0 if dilate else 1.0)[0]
    h, w = x.shape
    op = torch.maximum if dilate else torch.minimum
    acc = None
    for dy, dx in zip(*np.nonzero(structure)):
        window = padded[dy : dy + h, dx : dx + w]
        acc = window if acc is None else op(acc, window)
    return acc > 0.5


def binary_dilation(x, structure):
    return _morph_window(x, structure, True)


def binary_erosion(x, structure):
    return _morph_window(x, structure, False)


def binary_closing(x, structure):
    """Dilation then erosion (skimage.binary_closing; utils.py:252)."""
    return binary_erosion(binary_dilation(x, structure), structure)


# ---------------------------------------------------------------------------
# On the host, through native.py
# ---------------------------------------------------------------------------


def _host(mask) -> np.ndarray:
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    return np.asarray(mask)


def remove_small_objects(mask, min_size=20) -> np.ndarray:
    """skimage.morphology.remove_small_objects of a boolean mask,
    8-connectivity: bool (H, W)."""
    return native.remove_small_objects(_host(mask), min_size)


def get_rois(mask_u8) -> np.ndarray:
    """utils.py:250-254: remove objects under 20 pixels (8-connected), close
    with disk(2), label (8-connected). Returns the int32 label image."""
    mask = remove_small_objects(_host(mask_u8) > 0, min_size=20)
    st = disk(2)
    mask = native.binary_erosion(native.binary_dilation(mask, st), st, border_value=1)
    return native.cc_label(mask)[0]


def region_centroids(labels, min_area=10):
    """(x, y) centroids of the regions of at least min_area pixels, in
    ascending label order: the query points of morphology_cleaning
    (utils.py:256-301)."""
    labels = _host(labels)
    n = int(labels.max()) if labels.size else 0
    if n == 0:
        return []
    areas, centroids, _ = native.region_props(labels, n)
    return [(float(centroids[i, 0]), float(centroids[i, 1])) for i in range(n)
            if areas[i] >= min_area]


# ---------------------------------------------------------------------------
# Plain twins (scipy)
# ---------------------------------------------------------------------------

_EIGHT = np.ones((3, 3), bool)


def remove_small_objects_plain(mask, min_size=20) -> np.ndarray:
    from scipy import ndimage as ndi

    mask = _host(mask).astype(bool)
    labels, n = ndi.label(mask, structure=_EIGHT)
    if n == 0:
        return mask.copy()
    keep = np.bincount(labels.ravel()) >= min_size
    keep[0] = False
    return keep[labels]


def get_rois_plain(mask_u8) -> np.ndarray:
    from scipy import ndimage as ndi

    mask = remove_small_objects_plain(_host(mask_u8) > 0, min_size=20)
    st = disk(2)
    mask = ndi.binary_dilation(mask, structure=st)
    mask = ndi.binary_erosion(mask, structure=st, border_value=1)
    return ndi.label(mask, structure=_EIGHT)[0]


def region_centroids_plain(labels, min_area=10):
    labels = _host(labels)
    points = []
    for i in range(1, int(labels.max()) + 1 if labels.size else 1):
        ys, xs = np.nonzero(labels == i)
        if ys.size >= min_area:
            points.append((float(xs.mean()), float(ys.mean())))
    return points
