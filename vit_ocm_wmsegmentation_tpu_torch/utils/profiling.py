"""The port's spans and traces.

Counterpart of ``vit_ocm_wmsegmentation_tpu/utils/profiling.py``:

* :func:`annotate`: the port's one span primitive. While a profiler runs it
  is a ``torch.profiler.record_function`` range, so the span lands in that
  profiler's own trace, on the clock of the device's kernels and copies;
  otherwise it is one shared null context, so that a span costs a flag test
  and nothing is built or dispatched;
* :func:`trace`: a ``torch.profiler`` capture of CPU and CUDA activity,
  exported as a Chrome trace into a directory.

The spans are named ``<module>.<stage>``: ``pipeline.segment_mosaic`` and
``pipeline.segment_mosaic_streamed`` around a mosaic, with the leaves
``pipeline.tiles``, ``pipeline.tile_maps``, ``pipeline.stitch`` and
``pipeline.threshold`` (the streamed path's ``pipeline.band`` a tile row),
``vit.cls_attention_grid`` (and inside it, for the DINOv2 block kind,
``vit.tokens`` and one ``vit.ffn`` a block); ``mim.step`` around a training step, with
``mim.forward``, ``mim.backward`` and ``mim.optimizer``; ``data.device_aug``
around each batch of the device-augmentation loader. A top span holds only
host code of its own; every op that launches work runs under a leaf.
"""

from __future__ import annotations

import contextlib
import os

import torch

_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """``with annotate(name): ...``: a named span in the running profiler's
    trace, or the shared null context when no profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace(dir): step()`` writes ``dir/trace.json`` (Chrome trace
    format); CUDA activity is recorded when a CUDA device is present, and
    the device is synchronized before the capture stops, so that the work
    the block issued is in the trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
