"""Faults planted under the timed path, for the tests and the readings that
show the correctness check catches them. The benchmark's own runs never use
them.

Serving (a segment factory in the program's place):

* ``stale``: each mosaic gets the previous mosaic's answer;
* ``half_batch``: the ViT runs on the first half of each tile batch, the
  other half gets the mean of its maps;
* ``alter_answer``: the mask's first hundredth of rows is inverted where it
  is produced.

Training (a trainer in the program's place):

* ``stale``: each step leaves the parameters and the optimizer state as they
  were;
* ``half_batch``: each step runs on the first half of its batch, the loss
  the mean over those rows;
* ``alter_answer``: each step's loss is reported 1 % high.
"""

from __future__ import annotations

import contextlib

import torch

from .runners import serve, train

SERVE_FAULTS = ("stale", "half_batch", "alter_answer")
TRAIN_FAULTS = ("stale", "half_batch", "alter_answer")


@contextlib.contextmanager
def _half_vit(vit_module):
    inner = vit_module.cls_attention_grid

    def half(model, x, *a, **k):
        h = max(1, x.shape[0] // 2)
        out = inner(model, x[:h], *a, **k)
        rest = out.mean(0, keepdim=True).expand((x.shape[0] - h,) + tuple(out.shape[1:]))
        return torch.cat([out, rest])

    vit_module.cls_attention_grid = half
    try:
        yield
    finally:
        vit_module.cls_attention_grid = inner


def serve_factory(fault: str):
    """A segment factory (serve.run's ``segment_factory``) with ``fault``."""
    if fault not in SERVE_FAULTS:
        raise ValueError(f"fault {fault!r} not in {SERVE_FAULTS}")

    def factory(cell, state, device):
        seg, vit_module = serve.program_segment(cell, state, device)
        last = []

        def segment(img):
            if fault == "half_batch":
                with _half_vit(vit_module):
                    return seg(img)
            mask, attn = seg(img)
            if fault == "alter_answer":
                mask = mask.clone()
                rows = max(1, mask.shape[0] // 100)
                mask[:rows] = 255 - mask[:rows]
                return mask, attn
            prev = last[0] if last else (mask, attn)
            last[:] = [(mask, attn)]
            return prev

        return segment, None

    return factory


class FaultyTrainer(train.ProgramTrainer):
    """The port's trainer with ``fault`` planted in its step."""

    def __init__(self, cell, state, device, loader_len, fault):
        if fault not in TRAIN_FAULTS:
            raise ValueError(f"fault {fault!r} not in {TRAIN_FAULTS}")
        super().__init__(cell, state, device, loader_len)
        self.fault = fault

    def step(self, x, mask):
        if self.fault == "half_batch":
            h = max(1, x.shape[0] // 2)
            return super().step(x[:h], mask[:h])
        if self.fault == "alter_answer":
            return super().step(x, mask) * 1.01
        saved = [p.detach().clone() for p in self.model.parameters()]
        loss = super().step(x, mask)
        with torch.no_grad():
            for p, s in zip(self.model.parameters(), saved):
                p.copy_(s)
        self.optimizer.opt.state.clear()
        return loss


def train_factory(fault: str):
    def factory(cell, state, device, loader_len):
        return FaultyTrainer(cell, state, device, loader_len, fault)

    return factory
