"""Test configuration: force the CPU backend with 8 virtual devices.

The tests run without an accelerator; multi-device sharding tests use an
8-device virtual CPU mesh.  Kernel tests run the Pallas kernel through the
interpreter.  Tests that need the GPU carry the ``gpu`` marker and skip
here (the ``gpu`` fixture decides, never module import); their content
runs on the card in chip_smoke.py.  Must run before jax initializes.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (the gpu "
        "fixture decides at run time)")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")


@pytest.fixture
def interpret_ingest(monkeypatch):
    """Route every kernel ingest entry point through the Pallas
    interpreter (tests run on the virtual CPU mesh)."""
    import fdreadoutlibs_jax.ops.ingest as ingest_mod

    for name in ("process_packed_frames", "process_time2_feed",
                 "process_packed_daphne"):
        orig = getattr(ingest_mod, name)

        def patched(words, stack, cfg, C, _orig=orig, **kw):
            kw["interpret"] = True
            return _orig(words, stack, cfg, C, **kw)

        monkeypatch.setattr(ingest_mod, name, patched)
