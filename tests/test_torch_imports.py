"""The port stands alone: it never imports JAX or the JAX package, and its
kernel wrappers raise where there is no kernel instead of falling back."""

import ast
import pathlib

import pytest
import torch

from vit_ocm_wmsegmentation_tpu_torch import build, mim, sw_processing
from vit_ocm_wmsegmentation_tpu_torch.ops import flash_attention as fa
from vit_ocm_wmsegmentation_tpu_torch.ops import fused_mlp as fm
from vit_ocm_wmsegmentation_tpu_torch.ops import threshold as th

PORT = pathlib.Path(__file__).resolve().parent.parent / "vit_ocm_wmsegmentation_tpu_torch"
# the JAX package, and the repository's tools/ (its probes import JAX; the
# port keeps its own copies under vit_ocm_wmsegmentation_tpu_torch/tools);
# cv2, transformers and optax, which the card's machine does not have (the
# port reads images like cv2 in train/supervised.py, and its tests alone
# build HF models)
FORBIDDEN = ("jax", "jaxlib", "vit_ocm_wmsegmentation_tpu", "tools", "cv2", "transformers",
             "optax")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name):
    # exact names or their submodules: vit_ocm_wmsegmentation_tpu_torch is allowed
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: p.name)
def test_port_module_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_import_check_matches_names_exactly():
    assert _forbidden("jax.numpy") and _forbidden("vit_ocm_wmsegmentation_tpu.ops")
    assert not _forbidden("vit_ocm_wmsegmentation_tpu_torch.ops") and not _forbidden("jaxtyping")
    assert _forbidden("tools.probe_dot") and not _forbidden("vit_ocm_wmsegmentation_tpu_torch.tools")
    assert _forbidden("cv2") and _forbidden("transformers.models") and _forbidden("optax")
    assert list(PORT.rglob("*.py")), "port package not found"


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor that is neither on the CPU nor on a CUDA device has no
    kernel: the wrappers raise rather than take the plain twin."""
    with pytest.raises(ValueError, match="no kernel"):
        fa.attention_qkv(_meta(1, 8, 3 * 64), 1, 8)
    args = (_meta(4, 384), _meta(384), _meta(384), _meta(1536, 384), _meta(1536),
            _meta(384, 1536), _meta(384))
    with pytest.raises(ValueError, match="no kernel"):
        fm.fused_mlp_block(*args)
    with pytest.raises(ValueError, match="no kernel"):
        fm.fused_mlp_block_lnout(*args, _meta(384), _meta(384))
    with pytest.raises(ValueError, match="no kernel"):
        fm.fused_mlp_block_h1(*args)
    with pytest.raises(ValueError, match="no kernel"):
        fm.fused_mlp_bwd(_meta(4, 384), _meta(4, 384), _meta(4, 1536), _meta(384), _meta(384),
                         _meta(1536, 384), _meta(384, 1536))
    q = _meta(2, 8, 128)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_bwd(q, q, q, q, _meta(2, 8), q)
    with pytest.raises(ValueError, match="no kernel"):
        th.histogram_u8_kernel(torch.empty(64, dtype=torch.uint8, device="meta"))
    assert fa.attention_qkv.launches == fm.fused_mlp_block.launches == 0
    assert th.histogram_u8_kernel.launches == 0
    assert fa.flash_attention.launches == fa.flash_attention_bwd.launches == 0
    assert fm.fused_mlp_block_h1.launches == fm.fused_mlp_bwd.launches == 0


def test_cuda_requests_raise_on_a_host_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        build.library()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sw_processing.main(["--image_path", str(tmp_path), "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):  # the default device
        mim.main(["--image_path", str(tmp_path), "--output", str(tmp_path / "out"),
                  "--output_dir", str(tmp_path / "log")])
