"""The runners, one a traffic kind: ``runners/<kind>.py`` with ``run(cell, seed,
seconds, trace, device, tmpdir, **hooks)``, found by the traffic's ``kind``."""
