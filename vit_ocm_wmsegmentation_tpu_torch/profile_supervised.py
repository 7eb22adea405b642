"""Where a step of the supervised flows' time goes, on one CUDA device.

    python -m vit_ocm_wmsegmentation_tpu_torch.profile_supervised [--flow finetune unet pgt swin]

The workloads are chip_smoke.py's phases 12-13 with random weights from
seed 0: the finetune step (ViT-S/8 at depth 12 with the 2-layer decoder,
384^2, batch 3, f32), the UNet step (512^2, batch 8, the UNet CLI's
defaults) and PGT's (the UNet student at 384^2, batch 3, on the teacher's
masks), and Swin-Tiny's micro-step (224^2, batch 8, f32 and AMP bf16).
Prints the card's name and power limit, then for each: the device time of
each kernel in one torch.profiler run, that run's wall time and idle share,
the host's busiest operators, and the step without the profiler (CUDA
events, median of 5) with its peak device memory. The UNet runs as the CLIs
run it: NCHW weights, the NHWC batch seen as NCHW, cuDNN's algorithm search
off.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .data.synthetic import seg_batch
from .models import probing, swin, unet
from .pipeline import exact_matmuls
from .train import classifier as cls
from .train import supervised as sup
from .utils.profiling import card_line, cuda_ms, kernel_table

FLOWS = ("finetune", "unet", "pgt", "swin")


def _profile(what, fn, host_top=8):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    print(what)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernel_table(prof, wall)
    rows = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), reverse=True)
    print(f"  host: {sum(r[0] for r in rows):.3f} ms of operator self time")
    for ms, count, key in rows[:host_top]:
        print(f"    {ms:9.3f} ms x{count:5d}  {key[:90]}")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(fn, iters=5, warmup=1)
    print(f"  without the profiler (CUDA events, median of 5): {ms:.3f} ms, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--flow", nargs="+", choices=FLOWS, default=list(FLOWS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_supervised: no CUDA device available")
    print(card_line())
    dev = torch.device("cuda")
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    with exact_matmuls():
        if "finetune" in args.flow:
            x, y = seg_batch(3, 384, 1, dev)
            model = probing.init(probing.finetune_vit_config(384, 8), gen(), 2, dev)
            step, _ = sup.make_seg_step(probing.apply, model, sup.make_adam(model, 1e-4))
            _profile("[f32] finetune train step, 3 x 384^2, ViT-S/8 depth 12, 2-layer decoder",
                     lambda: step(x, y, 1e-4))
            del model, step
        for flow, n, size in (("unet", 8, 512), ("pgt", 3, 384)):
            if flow not in args.flow:
                continue
            x, y = seg_batch(n, size, 3, dev)
            model = unet.init(gen(), dev)
            step, _ = sup.make_seg_step(unet.apply, model, sup.make_adam(model, 1e-4))
            _profile(f"[f32] UNet train step ({flow}), {n} x {size}^2", lambda: step(x, y, 1e-4))
            del model, step
        if "swin" in args.flow:
            rng = np.random.default_rng(0)
            x = torch.from_numpy(rng.random((8, 224, 224, 3), dtype=np.float32)).to(dev)
            y = torch.from_numpy(rng.integers(0, 4, 8)).to(dev)
            for amp in (False, True):
                model = swin.init(swin.SwinConfig(num_classes=4), gen(), dev)
                opt = cls.AccumulatedAdamW(list(model.parameters()),
                                           cls.hf_linear_schedule(5e-5, 100), 4)
                step, _ = cls.make_classifier_step(model, opt, amp=amp)
                _profile(f"[{'bf16' if amp else 'f32'}] Swin-Tiny optimizer step: 4 micro-steps "
                         f"of 8 x 224^2", lambda: [step(x, y) for _ in range(4)])
                del model, opt, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
