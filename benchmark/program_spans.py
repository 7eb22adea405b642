"""What the per-layer metrics read of the program's own spans in a traced
run's :class:`~benchmark.tracing.TraceView`.

The port opens its spans through ``utils.profiling.annotate`` inside the
profiler's trace, named ``<module>.<stage>``: around a mosaic
``pipeline.segment_mosaic`` or ``pipeline.segment_mosaic_streamed``, which
hold host code alone, with the leaves ``pipeline.tiles``,
``pipeline.tile_maps``, ``pipeline.stitch``, ``pipeline.threshold`` (and the
ViT's ``vit.cls_attention_grid`` inside ``pipeline.tile_maps``); around a
training step ``mim.step``; around each batch of the device loader
``data.device_aug``. They nest inside the benchmark's own spans (``segment``,
``vit``, ``step``, ``loader``), so a device operation's innermost span
(``view.ops``) is the program's. Host times are the main thread's spans
(``view._spans[view.main_tid]``) clipped to the traced window. Each reader
returns None where the trace holds none of the spans it reads, or no
operation ran on the device, as a trace of a program without these spans
does.
"""

from __future__ import annotations

from benchmark.tracing import length, union

PIPELINE_LEAVES = frozenset({"pipeline.tiles", "pipeline.tile_maps", "pipeline.stitch",
                             "pipeline.threshold"})
MOSAIC_TOPS = frozenset({"pipeline.segment_mosaic", "pipeline.segment_mosaic_streamed"})
STEP_TOP = frozenset({"mim.step"})
LOADER = frozenset({"data.device_aug"})


def device_ms(view, spans) -> float:
    """Milliseconds of the union of the device operations whose innermost
    launching span is one of ``spans``."""
    return length(union((s, t) for _, s, t, sp in view.ops if sp in spans)) / 1e3


def host_ms(view, names):
    """(milliseconds, count) of the main thread's spans named one of
    ``names``, each clipped to the traced window."""
    total, count = 0.0, 0
    for s, e, name in view._spans.get(view.main_tid, []):
        if name in names:
            s, e = max(s, view.t0), min(e, view.t1)
            if e > s:
                total += e - s
                count += 1
    return total / 1e3, count


def pipeline_dev_ms_per_mp(view, cell):
    """Device milliseconds a traced megapixel of the pipeline's work outside
    the ViT: the union of the device operations launched under
    ``pipeline.tiles``, ``pipeline.tile_maps`` (input cast, head mean,
    min-max, resize; the ViT's own launch under ``vit.cls_attention_grid``),
    ``pipeline.stitch`` and ``pipeline.threshold``."""
    mp = view.units.get("mp")
    dev = device_ms(view, PIPELINE_LEAVES)
    if not mp or dev <= 0:
        return None
    return dev / mp


def issue_ms_per_mp(view, cell):
    """Host milliseconds a traced megapixel inside the main thread's
    ``pipeline.segment_mosaic[_streamed]`` spans: how long the host takes to
    issue a mosaic's work, to set against the card's busy time a megapixel.
    Read under the profiler, which slows the host."""
    mp = view.units.get("mp")
    ms, count = host_ms(view, MOSAIC_TOPS)
    if not mp or not count or not view.ops:
        return None
    return ms / mp


def aug_dev_ms(view, cell):
    """Device milliseconds a traced batch under ``data.device_aug``: the
    device loader's gather, upload and augmentation (the epoch's set-up
    included)."""
    batches = view.units.get("batches")
    dev = device_ms(view, LOADER)
    if not batches or dev <= 0:
        return None
    return dev / batches


def issue_ms_per_step(view, cell):
    """Host milliseconds a traced step inside the main thread's ``mim.step``
    spans: forward, backward and optimizer issued, to set against the
    step's device time. Read under the profiler, which slows the host."""
    steps = view.units.get("steps")
    ms, count = host_ms(view, STEP_TOP)
    if not steps or not count or not view.ops:
        return None
    return ms / steps
