"""Chan-Vese active-contour segmentation on tensors.

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/chan_vese.py``:
skimage.segmentation.chan_vese as utils.py:199-225 calls it (mu 0.25,
lambda1 = lambda2 = 1, tol 1e-3, at most 200 steps, dt 0.5, checkerboard
start) with the same semi-implicit update (Getreuer, IPOL 2012). The JAX
package's while loop is a Python loop here: each step reads the RMS change
of the level set on the host and stops once it is at most tol.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def checkerboard_level_set(shape, square_size=5, device=None):
    """skimage's checkerboard start: sin(pi/s * y) * sin(pi/s * x)."""
    yy = torch.arange(shape[0], dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(shape[1], dtype=torch.float32, device=device)[None, :]
    return torch.sin(math.pi / square_size * yy) * torch.sin(math.pi / square_size * xx)


def _averages(image, phi):
    inside = (phi > 0).float()
    c1 = (image * inside).sum() / torch.clamp_min(inside.sum(), 1.0)
    c2 = (image * (1.0 - inside)).sum() / torch.clamp_min((1.0 - inside).sum(), 1.0)
    return c1, c2


def _variation(image, phi, mu, lambda1, lambda2, dt):
    """One semi-implicit level-set update."""
    eta = 1e-16
    p = F.pad(phi[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    phixp = p[1:-1, 2:] - p[1:-1, 1:-1]
    phixn = p[1:-1, 1:-1] - p[1:-1, :-2]
    phix0 = (p[1:-1, 2:] - p[1:-1, :-2]) / 2.0
    phiyp = p[2:, 1:-1] - p[1:-1, 1:-1]
    phiyn = p[1:-1, 1:-1] - p[:-2, 1:-1]
    phiy0 = (p[2:, 1:-1] - p[:-2, 1:-1]) / 2.0

    c1c = torch.rsqrt(eta + phixp**2 + phiy0**2)
    c2c = torch.rsqrt(eta + phixn**2 + phiy0**2)
    c3c = torch.rsqrt(eta + phix0**2 + phiyp**2)
    c4c = torch.rsqrt(eta + phix0**2 + phiyn**2)

    k = p[1:-1, 2:] * c1c + p[1:-1, :-2] * c2c + p[2:, 1:-1] * c3c + p[:-2, 1:-1] * c4c
    c1, c2 = _averages(image, phi)
    # skimage's _cv_delta(x, eps=1) = eps / (eps^2 + x^2), without the
    # smoothed Dirac's 1/pi: its evolution rate is matched
    delta = dt / (1.0 + phi * phi)
    diff = -lambda1 * (image - c1) ** 2 + lambda2 * (image - c2) ** 2
    new_phi = phi + delta * (mu * k + diff)
    return new_phi / (1.0 + mu * delta * (c1c + c2c + c3c + c4c))


def chan_vese(image, mu=0.25, lambda1=1.0, lambda2=1.0, tol=1e-3, max_num_iter=200, dt=0.5):
    """Segment a (H, W) grayscale image: the bool mask phi > 0. As in
    skimage the image is shifted and scaled to [0, 1] first; uint8 input is
    taken as it is (utils.py:208-211 passes uint8)."""
    img = image.float()
    img = img - img.min()
    mx = img.max()
    img = torch.where(mx > 0, img / torch.clamp_min(mx, 1e-38), img)
    phi = checkerboard_level_set(img.shape, device=img.device)
    for _ in range(max_num_iter):
        new_phi = _variation(img, phi, mu, lambda1, lambda2, dt)
        phivar = torch.sqrt((new_phi - phi).square().mean())
        phi = new_phi
        if not float(phivar) > tol:
            break
    return phi > 0
