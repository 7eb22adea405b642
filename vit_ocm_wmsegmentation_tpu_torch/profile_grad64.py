"""How far one MIM step's float32 gradients lie from float64, route by
route, and why, on one CUDA device.

    python -m vit_ocm_wmsegmentation_tpu_torch.profile_grad64 [--route ln_qkv save_p ...]

The workload is profile_mim.py's (chip_smoke.py phase 4b's inputs): the
SimMIM ViT (width 384, depth 4, 3 heads of 128, patch 8) with random
weights from seed 0, 16 synthetic 384^2 images and their masks from
``np.random.default_rng(0)``. For each route asked for, the gradients of one
step's loss (no update) in float32 on the kernel route and on the plain
route (every training kernel wrapper swapped for its plain twin), and once
in float64 on the plain route: the model and the images cast to float64,
and ``Tensor.float`` of a float64 tensor left as it is, so that the twins,
which cast their operands to float32 before they sum, sum in float64.
Prints the card's name and power limit, then per route and parameter
tensor max|g64|, each float32 route's distance from float64, max|g - g64| /
max|g64|, and the kernel route's from the plain route's, max|g - gplain| /
max|gplain| (chip_smoke.py phase 4b's figure); per route the largest of
each, and the tensors where the kernel route lies further from float64 than
the plain route does. The loss is a masked L1, whose derivative is the sign
of each residual x - x_rec: each float32 route's count of masked residuals
whose sign differs from float64's, the largest float64 |x - x_rec| among
them, and both routes' distances from float64 again with every residual's
sign taken from float64 (the loss ``(x - x_rec) * sign64`` in place of
``|x - x_rec|``, equal to it up to those residuals).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
from unittest import mock

import torch

from .data.synthetic import MIM_SIZE, mim_batch
from .models import simmim
from .ops.twins import TRAIN_ROUTES, float64_twins, plain_training_route
from .pipeline import exact_matmuls
from .utils.profiling import card_line


@contextlib.contextmanager
def l1_signs(sign):
    """simmim.masked_l1 with |x - x_rec| as (x - x_rec) * sign: the same
    loss where the signs are the residuals', a derivative of the given
    signs everywhere."""
    masked_l1 = simmim.masked_l1

    def signed_l1(x, x_rec, mask, p, pix_count=None):
        _, pix_mask = masked_l1(x, x_rec, mask, p)
        l1 = (x - x_rec) * sign.to(x.dtype)
        count = pix_mask.float().sum() if pix_count is None else pix_count
        return (l1 * pix_mask).float().sum() / (count + 1e-5) / 3.0, pix_mask

    with mock.patch.object(simmim, "masked_l1", signed_l1):
        yield


def step_grads(model, x, mask, routes):
    """The gradients of one MIM step's loss with respect to every parameter,
    and the masked residuals (x - x_rec) * pixel mask of the L1 loss."""
    loss, x_rec, pix_mask = model(x, mask, False, routes)
    grads = [g.detach() for g in torch.autograd.grad(loss, list(model.parameters()))]
    return grads, ((x - x_rec.detach()) * pix_mask).detach()


def _rel(a, b):
    """max|a - b| / max|b|, in float64."""
    b = b.double()
    return float((a.double() - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--route", nargs="+", choices=sorted(TRAIN_ROUTES),
                        default=["default", "ln_qkv", "save_p"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_grad64: no CUDA device available")
    print(card_line())
    dev = torch.device("cuda")
    x, mask = mim_batch(dev)
    model = simmim.init(simmim.mim_vit_config(MIM_SIZE, 8), torch.Generator().manual_seed(0), dev)
    model64 = copy.deepcopy(model).double()
    names = [name for name, _ in model.named_parameters()]
    with exact_matmuls():
        for route in args.route:
            routes = TRAIN_ROUTES[route]
            with plain_training_route(), float64_twins():
                ref, resid64 = step_grads(model64, x.double(), mask, routes)
            if any(g.dtype != torch.float64 for g in ref):
                raise AssertionError("the float64 reference ran in another dtype")
            sign64 = torch.sign(resid64)
            kernel, resid_k = step_grads(model, x, mask, routes)
            with l1_signs(sign64):
                kernel_s, _ = step_grads(model, x, mask, routes)
            with plain_training_route():
                plain, resid_p = step_grads(model, x, mask, routes)
                with l1_signs(sign64):
                    plain_s, _ = step_grads(model, x, mask, routes)
            print(f"[f32] MIM step gradients, route {route}: distance from float64, "
                  "max|g - g64| / max|g64|")
            rows = []
            for name, k, p, r in zip(names, kernel, plain, ref):
                rows.append((name, float(r.abs().max()), _rel(k, r), _rel(p, r), _rel(k, p)))
                print(f"  {name}: max|g64| {rows[-1][1]:.3e}; kernel {rows[-1][2]:.3e}, plain "
                      f"{rows[-1][3]:.3e}; kernel vs plain {rows[-1][4]:.3e}")
            worst = max(rows, key=lambda row: row[4])
            further = [row[0] for row in rows if row[2] > row[3]]
            print(f"  route {route}: largest kernel {max(r[2] for r in rows):.3e}, plain "
                  f"{max(r[3] for r in rows):.3e}; largest kernel vs plain {worst[4]:.3e} "
                  f"({worst[0]}: kernel {worst[2]:.3e}, plain {worst[3]:.3e} from float64); "
                  f"kernel further from float64 than plain on {len(further)} of {len(rows)} "
                  f"tensors: {further}")
            for what, resid, grads, signed in (("kernel", resid_k, kernel, kernel_s),
                                               ("plain", resid_p, plain, plain_s)):
                flips = torch.sign(resid) != sign64
                near = float(resid64.abs()[flips].max()) if bool(flips.any()) else 0.0
                dist = [_rel(g, r) for g, r in zip(grads, ref)]
                dist_s = [_rel(g, r) for g, r in zip(signed, ref)]
                pe = names.index("encoder.pos_embed")
                print(f"  route {route}, {what}: {int(flips.sum())} masked L1 residuals of "
                      f"another sign than float64's (largest float64 |x - x_rec| among them "
                      f"{near:.3e}); largest distance from float64 {max(dist):.3e} (pos_embed "
                      f"{dist[pe]:.3e}), with float64's signs {max(dist_s):.3e} (pos_embed "
                      f"{dist_s[pe]:.3e})")
            del kernel, plain, ref, kernel_s, plain_s
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
