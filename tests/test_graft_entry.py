"""The driver's entry points must work as shipped.

Regression: the multi-device dryrun once failed because APAPipeline
seeded state through the *default* backend.  These tests import
__graft_entry__ as a caller does and run both entry points; conftest's
virtual 8-device CPU mesh stands in for an
--xla_force_host_platform_device_count run.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__  # noqa: E402


def test_entry_compiles_and_runs():
    import jax
    fn, args = __graft_entry__.entry()
    jitted = jax.jit(fn)
    jitted.lower(*args)  # compile-check (the driver's single-chip probe)
    hits, n_hits, state = jitted(*args)
    assert int(n_hits) >= 1  # the example args inject one pulse
    assert hits.shape[1] == 6


def test_dryrun_multichip_8_devices():
    __graft_entry__.dryrun_multichip(8)


def test_dryrun_multichip_uses_cpu_even_with_other_platform_env(monkeypatch):
    # JAX_PLATFORMS points at another backend: dryrun_multichip must
    # repin to cpu and still pass.
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    __graft_entry__.dryrun_multichip(4)
    import jax
    assert jax.config.jax_platforms == "cpu"


def test_pipeline_seed_is_host_side():
    """APAPipeline.process must not create arrays on the default device
    when seeding state (round-1 dryrun failure)."""
    from fdreadoutlibs_jax.formats import wibeth
    from fdreadoutlibs_jax.ops import TPGConfig
    from fdreadoutlibs_jax.parallel import APAPipeline, make_link_mesh

    mesh = make_link_mesh(2, backend="cpu")
    pipe = APAPipeline(2, TPGConfig(threshold=120), mesh=mesh)
    words = np.zeros((2, wibeth.N_TIME_SAMPLES, 28), dtype=np.uint32)
    frames = wibeth.empty_frames(1)
    adcs = np.full((1, 64, 64), 800, np.uint16)
    wibeth.set_adcs(frames, adcs)
    words[:] = wibeth.frames_bytes_to_u32(frames)[0]
    hits, n_hits, total = pipe.process(words)
    assert total == 0
    # seeded pedestals match the first sample
    ped = np.asarray(pipe.state["pedestals"])
    assert (ped == 800).all()
