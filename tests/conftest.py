import os

# Tests run on the CPU, on a virtual 8-device mesh so multi-device
# sharding logic is exercised without several cards.  Set JAX_PLATFORMS
# to another platform (e.g. JAX_PLATFORMS=cuda) to keep that device:
# the tests marked ``gpu`` then run on it, as chip_smoke.py does.
if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: compiles and runs on an NVIDIA GPU; skips where there is none",
    )
