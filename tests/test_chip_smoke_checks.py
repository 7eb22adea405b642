"""chip_smoke.py's phase-0 report on ptxas' output, on made-up reports: a
setmaxnreg that ptxas ignored (warning C7508) in a kernel of SASS_CHECKS
fails the build check before the SASS is read. Runs without a card."""

import importlib.util
import os

import pytest

from vit_ocm_wmsegmentation_tpu_torch import build

ROOT = os.path.join(os.path.dirname(__file__), "..")
KERNEL = "_ZN6vitocm22attention_wgmma_kernelILi64ELb0ELi2EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiii"
OTHER = "_ZN6vitocm13other_kernelEv"


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke_checks", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class NoSass:  # cuobjdump's output of a library that holds no kernel
        stdout = ""

    monkeypatch.setattr(mod.subprocess, "run", lambda *a, **k: NoSass())
    monkeypatch.setattr(build, "_nvcc", lambda: "/bin/nvcc")
    monkeypatch.setitem(build.build_info, "path", "lib.so")
    return mod


def _report(*lines):
    return "\n".join(lines) + "\n"


def _entry(fn):
    return (f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'",
            f"ptxas info    : Function properties for {fn}",
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            "ptxas info    : Used 168 registers, used 1 barriers")


@pytest.mark.parametrize("named", [True, False])
def test_ignored_setmaxnreg_of_a_checked_kernel_fails(smoke, monkeypatch, named):
    """The warning names its function, or sits in that kernel's report."""
    warn = ("ptxas info    : (C7508) Potential Performance Loss: 'setmaxnreg' ignored"
            + (f" in function '{KERNEL}'" if named else ""))
    monkeypatch.setitem(build.build_info, "ptxas", _report(*_entry(KERNEL)[:2], warn,
                                                           *_entry(KERNEL)[2:]))
    with pytest.raises(AssertionError, match="ignored a setmaxnreg of .*attention_wgmma_kernel"):
        smoke.check_kernel_builds()


def test_report_without_c7508_reaches_the_sass_check(smoke, monkeypatch):
    """A clean report, and a C7508 named for a kernel outside SASS_CHECKS, pass
    the ptxas check; the made-up library then fails the SASS count."""
    warn = f"ptxas info    : (C7508) Potential Performance Loss: in function '{OTHER}'"
    monkeypatch.setitem(build.build_info, "ptxas", _report(*_entry(KERNEL), warn))
    with pytest.raises(AssertionError, match="instances in the SASS"):
        smoke.check_kernel_builds()
