"""The benchmark's own tests run on the CPU with four virtual devices (the
4-card cell's mesh), at sizes a test run can hold.  Run them with

    python -m pytest perfbench/tests -q
"""

import os

os.environ.setdefault("PYFFT_TPU_NO_CACHE", "1")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")
