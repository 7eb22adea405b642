"""The port's CLIs on a process group of 2 CPU ranks (gloo): the MIM CLI's
epochs, checkpoints and AUTO_RESUME under data parallelism, pipeline
parallelism and FSDP, and the serving CLI's ``--mesh``, whose files equal
the one-process CLI's.

One group of 2 spawned ranks (tests/parallel_workers.py) runs every CLI call
of this module once, in order; the tests read its results and the files.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from vit_ocm_wmsegmentation_tpu_torch import mim, sw_processing
from vit_ocm_wmsegmentation_tpu_torch.parallel import dryrun

import parallel_workers as pw
from port_helpers import one_torch_thread  # noqa: F401  (autouse)

# (epochs, --opts) of the MIM calls into one output, each resuming the last:
# data parallel, again, pipelined over 2 stages (the stage count changed:
# parameters only), again (same count: optimizer too), data parallel (changed
# back: parameters only), FSDP (same count as a data-parallel checkpoint's)
MIM_RUNS = [(1, []), (2, []), (3, ["TRAIN.PP_STAGES", "2"]), (4, ["TRAIN.PP_STAGES", "2"]),
            (5, []), (6, ["TRAIN.FSDP", "True"])]
# per run: the checkpoint's pp_stages tag, the optimizer updates it holds
# (2 steps an epoch) and whether the run resumed the optimizer state
WANT = [(None, 2, None), (None, 4, True), (2, 2, False), (2, 4, True), (None, 2, False),
        (None, 4, True)]


def _write_images(path, n, size):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray((rng.random((size, size + 8)) * 255).astype(np.uint8)).save(
            os.path.join(path, f"img{i}.png"))
    return str(path)


def _mim_args(tmp, src):
    return ["--image_path", src, "--image_size", "32", "--mask_patch_size", "8",
            "--batch_size", "4", "--warmup_epochs", "1", "--device", "cpu",
            "--output", str(tmp / "out"), "--output_dir", str(tmp / "log")]


def _sw_args(src, out, streamed):
    return ["--arch", "vit_tiny", "--image_path", src, "--image_size", "96", "--window_size",
            "48", "--stride", "16", "--device", "cpu", "--streamed", streamed,
            "--output_dir", str(out)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    src = _write_images(tmp / "imgs", 8, 40)
    mosaics = _write_images(tmp / "mosaics", 2, 96)
    mim_runs = [_mim_args(tmp, src) + ["--epochs", str(e)] + (["--opts", *o] if o else [])
                for e, o in MIM_RUNS]
    sw_runs = [_sw_args(mosaics, tmp / f"sw_{s}", s) + ["--mesh", "1"] for s in ("0", "1")]
    ranks = dryrun.spawn(pw.clis, 2, mim_runs, sw_runs, timeout_s=300)
    return {"tmp": tmp, "src": src, "mosaics": mosaics, "ranks": ranks}


def _ckpt(run, epoch):
    path = run["tmp"] / "out" / "vit_small" / "AM_32_Experimental_Run" / f"ckpt_epoch_{epoch}"
    return torch.load(path, weights_only=False)


def test_mim_epochs_and_checkpoints_on_two_ranks(run):
    """Every call trains its one epoch on both ranks with the same losses;
    rank 0 alone writes one checkpoint an epoch, in the plain single-device
    layout, a pipeline run's tagged with its stage count."""
    h0, h1 = (r["hists"] for r in run["ranks"])
    assert h0 == h1 and [len(h) for h in h0] == [1] * len(MIM_RUNS)
    assert all(np.isfinite(h).all() for h in h0)
    run_dir = run["tmp"] / "out" / "vit_small" / "AM_32_Experimental_Run"
    assert sorted(p for p in os.listdir(run_dir) if p.startswith("ckpt")) == [
        f"ckpt_epoch_{e}" for e in range(len(MIM_RUNS))]
    assert not [p for p in os.listdir(run_dir) if p.endswith(".tmp")]
    for epoch, (tag, updates, _) in enumerate(WANT):
        state = _ckpt(run, epoch)
        assert state.get("pp_stages") == tag and state["optimizer"]["updates"] == updates
        steps = {int(s["step"]) for s in state["optimizer"]["opt"]["state"].values()}
        assert steps == {updates}
        assert {k: v.shape for k, v in state["model"].items()} == {
            k: v.shape for k, v in _ckpt(run, 0)["model"].items()}


def test_mim_auto_resume_keeps_the_optimizer_only_for_the_same_stage_count(run):
    logs = (run["tmp"] / "log" / "log_rank0.txt").read_text().splitlines()
    resumed = [("optimizer updates" in l) for l in logs if "auto-resumed" in l]
    assert resumed == [w[2] for w in WANT[1:]]
    assert (run["tmp"] / "log" / "log_rank1.txt").exists()
    assert sum("pipeline parallelism: mesh={'data': 1, 'pipe': 2}" in l for l in logs) == 2
    assert sum("FSDP over mesh {'data': 2, 'model': 1}" in l for l in logs) == 1


def test_mim_first_epoch_equals_one_process(run, tmp_path):
    """The 2-rank data-parallel epoch and a one-process epoch from the same
    seed: the same checkpoint within f32 summation noise."""
    mim.main(_mim_args(tmp_path, run["src"]) + ["--epochs", "1"])
    one = torch.load(tmp_path / "out" / "vit_small" / "AM_32_Experimental_Run" / "ckpt_epoch_0",
                     weights_only=False)
    two = _ckpt(run, 0)
    assert one["optimizer"]["updates"] == two["optimizer"]["updates"] == 2
    for k, v in one["model"].items():
        assert float((two["model"][k] - v).abs().max()) <= 1e-5, k


def test_cpu_plain_route_depends_on_the_tile_batch():
    """Why the serving test below holds the attention image to 99.9 % of
    its pixels and not to its bytes: on the CPU the plain route's library
    products round differently for a batch of 16 tiles than for 8, so the
    CLS attention of vit_tiny (the CLI's arch there) moves in its last bits,
    which a tile's min-max x 255 and the 256-colour map can carry across a
    colour step. On the card every kernel computes a row independently of
    the batch, and chip_smoke.py holds the sharded mosaics bit for bit."""
    from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
    from vit_ocm_wmsegmentation_tpu_torch.models import vit

    model = vit.init(vit.VIT_TINY(patch_size=8), torch.Generator().manual_seed(0))
    img = torch.from_numpy((np.random.default_rng(0).random((96, 96)) * 255).astype(np.uint8))
    x = pl.to_model_input(pl.mosaic_tiles(img, 48, 16))
    with pl.exact_matmuls():
        whole = vit.cls_attention_grid(model, x).float()
        halves = torch.cat([vit.cls_attention_grid(model, x[:8]),
                            vit.cls_attention_grid(model, x[8:])])
    err = float((whole - halves.float()).abs().max())
    assert 0 < err < 1e-7, err


@pytest.mark.parametrize("streamed", ["0", "1"])
def test_serving_mesh_files_equal_one_process(run, tmp_path, streamed):
    """sw_processing --mesh 1 on 2 ranks (fused, then band-streamed): both
    ranks return the same masks, bit for bit those of the CLI in one
    process, and rank 0's mask files equal its files byte for byte; the
    attention image equals it in all but 0.1 % of its pixels at most (the
    test above says why)."""
    i = ["0", "1"].index(streamed)
    m0, m1 = (r["masks"][i] for r in run["ranks"])
    assert sorted(m0) == sorted(m1) == ["img0", "img1"]
    want = sw_processing.main(_sw_args(run["mosaics"], tmp_path, streamed))
    for name in m0:
        assert np.array_equal(m0[name], m1[name]) and np.array_equal(m0[name], want[name])
        for fname, _ in sw_processing.ARTIFACTS:
            got, ref = run["tmp"] / f"sw_{streamed}" / name / fname, tmp_path / name / fname
            if fname == "attention_map_sw.jpg":
                a, b = np.asarray(Image.open(got)), np.asarray(Image.open(ref))
                assert a.shape == b.shape and (a != b).any(axis=-1).mean() <= 1e-3
            else:
                assert got.read_bytes() == ref.read_bytes(), (name, fname)
