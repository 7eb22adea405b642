"""Multi-head self-attention in plain PyTorch.

Counterpart of ``vit_ocm_wmsegmentation_tpu/ops/attention.py``. Weights are
in nn.Linear's layout: ``qkv_weight`` (3D, D), ``proj_weight`` (D, D).

* :func:`mha` is the stock materialized attention, kept as the plain
  reference the kernel route is tested against; with ``return_attn`` it
  also returns the probabilities and q, k, v, which the ViT analysis API
  (``models/vit.get_intermediate_feat``) reads.
* :func:`cls_row_attention` is the last block of the inference path: only
  the CLS query's softmax row, since the pipeline reads attn[:, :, 0, 1:].

The JAX package's ``mha_auto`` dispatch onto the attention kernels is, in
the port, ``ops/flash_attention.mha_flash`` itself: ``prefer_folded=True``
is its training route (``mha_auto(train=True)``).
"""

from __future__ import annotations

import torch


def split_qkv(qkv, num_heads):
    """(B, N, 3D) -> (3, B, h, N, d), the reference's reshape/permute
    (dino/vision_transformer.py:80)."""
    b, n, dd3 = qkv.shape
    hd = dd3 // 3 // num_heads
    return qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)


def attention_scores(q, k):
    """softmax(q k^T / sqrt(d)) materialized, (B, h, N, N) in q's dtype:
    f32 logits and softmax, one cast."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    return torch.softmax(logits, dim=-1).to(q.dtype)


def mha(x, qkv_weight, qkv_bias, proj_weight, proj_bias, num_heads, return_attn=False):
    """Full MHSA with the (B, h, N, N) probabilities materialized. Returns
    out, or (out, attn (B, h, N, N), qkv (3, B, h, N, d)) with
    ``return_attn``: the reference layout the analysis and feature-
    clustering paths read (eval.py:186-202). Rounds as the JAX function
    does: the qkv product to x's dtype before its bias, the out projection
    and its bias in f32."""
    qkv = (x.float() @ qkv_weight.float().T).to(x.dtype)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.to(x.dtype)
    q, k, v = split_qkv(qkv, num_heads)
    attn = attention_scores(q, k)
    out = torch.einsum("bhqk,bhkd->bhqd", attn.float(), v.float()).to(x.dtype)
    b, h, n, hd = out.shape
    out = out.permute(0, 2, 1, 3).reshape(b, n, h * hd)
    out = (out.float() @ proj_weight.float().T + proj_bias.float()).to(x.dtype)
    if return_attn:
        return out, attn, torch.stack([q, k, v])
    return out


def cls_row_attention(x, qkv_weight, qkv_bias, num_heads):
    """CLS-row attention probabilities of one block: (B, h, N) in x's dtype,
    as the JAX function returns them. Only q[CLS] and K are computed (f32
    accumulation, f32 softmax), no V, no N^2 matrix."""
    b, n, d = x.shape
    wq, wk = qkv_weight[:d].float(), qkv_weight[d : 2 * d].float()
    q_cls = x[:, 0, :].float() @ wq.T
    k = x.float() @ wk.T
    if qkv_bias is not None:
        q_cls = q_cls + qkv_bias[:d].float()
        k = k + qkv_bias[d : 2 * d].float()
    hd = d // num_heads
    q_cls = q_cls.reshape(b, num_heads, hd)
    k = k.reshape(b, n, num_heads, hd).permute(0, 2, 1, 3)
    logits = torch.einsum("bhd,bhnd->bhn", q_cls, k) * (hd**-0.5)
    return torch.softmax(logits, dim=-1).to(x.dtype)
