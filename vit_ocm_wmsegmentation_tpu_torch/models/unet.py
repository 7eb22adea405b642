"""The classic 4-level UNet (the reference's model.py:227-320).

Counterpart of ``vit_ocm_wmsegmentation_tpu/models/unet.py``: encoder
3 -> 64 -> 128 -> 256 -> 512, bottleneck 1024, ConvTranspose(k=2, s=2)
decoder with skip concatenation, a 1x1 conv to one logit channel. Every
conv block is conv3x3 + BN + ReLU twice.

:class:`UNet` holds the parameters under the reference's state-dict keys
(``e1.conv.conv1``, ``b.bn2``, ``d1.up``, ``d1.conv.conv1``, ``outputs``
...), so a reference ``.pth`` loads with a strict ``load_state_dict``. The
BatchNorm running statistics are the modules' buffers. :func:`apply` takes
and gives NHWC, as the JAX package does, and runs NCHW inside (cuDNN
convolutions on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import nn as tnn

CHANNELS = (64, 128, 256, 512)
BOTTLENECK = 1024


class ConvBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(cout)


class EncoderBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBlock(cin, cout)


class DecoderBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cout, 2, stride=2)
        self.conv = ConvBlock(cout + cout, cout)


class UNet(nn.Module):
    """Parameter container with the reference's build_unet layout."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        cin = in_channels
        for i, c in enumerate(CHANNELS):
            setattr(self, f"e{i + 1}", EncoderBlock(cin, c))
            cin = c
        self.b = ConvBlock(CHANNELS[-1], BOTTLENECK)
        up_in = BOTTLENECK
        for i, c in enumerate(reversed(CHANNELS)):
            setattr(self, f"d{i + 1}", DecoderBlock(up_in, c))
            up_in = c
        self.outputs = nn.Conv2d(CHANNELS[0], 1, 1)


def init(generator: torch.Generator | None = None, device=None, in_channels: int = 3) -> UNet:
    """A UNet with torch's default init (each conv's kaiming-uniform from
    ``generator`` on the CPU; BN scale 1, bias 0, running mean 0, variance 1),
    moved to ``device``; every parameter requires a gradient."""
    model = UNet(in_channels)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            tnn.conv_init(m, generator)
        elif isinstance(m, nn.BatchNorm2d):
            tnn.batch_norm_init(m)
    return model.to(device) if device is not None else model


def _conv_block(blk: ConvBlock, x, train):
    x = F.relu(tnn.batch_norm(F.conv2d(x, blk.conv1.weight, blk.conv1.bias, padding=1),
                              blk.bn1, train))
    return F.relu(tnn.batch_norm(F.conv2d(x, blk.conv2.weight, blk.conv2.bias, padding=1),
                                 blk.bn2, train))


def apply(model: UNet, x, train: bool = False):
    """x (B, H, W, C) -> logits (B, H, W, 1); H and W divisible by 16, like
    the reference. ``train`` normalizes with the batch statistics and
    updates the running ones in place; otherwise the running ones."""
    h = tnn.nchw(x)
    skips = []
    for i in range(4):
        s = _conv_block(getattr(model, f"e{i + 1}").conv, h, train)
        skips.append(s)
        h = F.max_pool2d(s, 2, 2)
    h = _conv_block(model.b, h, train)
    for i in range(4):
        d = getattr(model, f"d{i + 1}")
        h = F.conv_transpose2d(h, d.up.weight, d.up.bias, 2)
        h = _conv_block(d.conv, torch.cat([h, skips[3 - i]], dim=1), train)
    return tnn.nhwc(F.conv2d(h, model.outputs.weight, model.outputs.bias))
