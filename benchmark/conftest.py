"""Stand-ins of the benchmark's later cells in the tiny benchmark of
``tests/conftest.py``, which rewrites each metric's ``workloads`` list onto
its tiny cells through ``STANDS_IN``: a cell added after that file gets its
stand-in here (a tiny cell of the same kind, or a name no tiny cell has)."""

from benchmark.tests import conftest as _tiny

_tiny.STANDS_IN.update({"vits8_streamed_32768": "tiny_streamed_cell",
                        "g14reg_fused_1512": "tiny_g14_cell"})
