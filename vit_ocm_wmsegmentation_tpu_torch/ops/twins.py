"""The plain route: every kernel wrapper swapped for its plain PyTorch twin,
so that tests and proofs on the card can hold the kernels against the twins
on the same call path.

* :func:`plain_route`: the mosaic path's wrappers (the int8 route's GEMM too);
* :func:`plain_training_route`: the training path's wrappers (the autograd
  Functions look them up at call time);
* :func:`float64_twins`: the twins sum in float64 when fed float64;
* :data:`TRAIN_ROUTES`: the training path's kernel routes by the names the
  MIM step's route sweeps take.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

from ..models.vit import TrainRoutes
from . import flash_attention as fa
from . import fused_mlp as fm
from . import ln_linear as ln
from . import quant as qz

TRAIN_ROUTES = {"default": TrainRoutes(), "ln_qkv": TrainRoutes(ln_qkv=True),
                "save_p": TrainRoutes(attn_save_p=True), "gp": TrainRoutes(mlp_save_gp=True),
                "all": TrainRoutes(mlp_save_gp=True, ln_qkv=True, attn_save_p=True)}


@contextlib.contextmanager
def plain_route():
    """Every kernel wrapper of the mosaic path (the int8 route's GEMM too)
    swapped for its plain twin."""
    with contextlib.ExitStack() as stack:
        for mod, name in ((fa, "attention_qkv"), (fm, "fused_mlp_block"),
                          (fm, "fused_mlp_block_lnout"), (qz, "int8_dot")):
            stack.enter_context(mock.patch.object(mod, name, getattr(mod, name + "_plain")))
        yield


@contextlib.contextmanager
def plain_training_route():
    """Every training kernel wrapper swapped for its plain twin (the
    autograd Functions look the wrappers up at call time)."""
    twins = {(fa, "flash_attention"): fa.flash_attention_plain,
             (fa, "flash_attention_bwd"): fa.flash_attention_bwd_plain,
             (fa, "flash_attention_savep"): fa.flash_attention_savep_plain,
             (fa, "flash_attention_bwd_savep"): fa.flash_attention_bwd_savep_plain,
             (fm, "fused_mlp_block_h1"): lambda *a: fm.fused_mlp_block_plain(*a, want_h1=True),
             (fm, "fused_mlp_bwd"): fm.fused_mlp_bwd_plain,
             (fm, "fused_mlp_block_gp"): fm.fused_mlp_block_gp_plain,
             (fm, "fused_mlp_bwd_gp"): fm.fused_mlp_bwd_gp_plain,
             (ln, "ln_linear"): ln.ln_linear_plain,
             (ln, "ln_linear_bwd"): ln.ln_linear_bwd_plain}
    with contextlib.ExitStack() as stack:
        for (mod, name), twin in twins.items():
            stack.enter_context(mock.patch.object(mod, name, twin))
        yield


@contextlib.contextmanager
def float64_twins():
    """``Tensor.float()`` returns a float64 tensor unchanged."""
    to_f32 = torch.Tensor.float

    def keep64(self, *args, **kwargs):
        return self if self.dtype == torch.float64 else to_f32(self, *args, **kwargs)

    with mock.patch.object(torch.Tensor, "float", keep64):
        yield
