"""The backend choice point, mesh construction, the compile-cache helper,
the kernel wrapper's shape contract and chip_smoke.py's comparators."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from fdreadoutlibs_jax.ops import Algorithm, TPGConfig  # noqa: E402
from fdreadoutlibs_jax.ops.backend import hit_backend, resolve_backend  # noqa: E402
from fdreadoutlibs_jax.ops.chanstate import init_chanstate, seed_chanstate  # noqa: E402
from fdreadoutlibs_jax.ops import pallas_tpg as P  # noqa: E402


# ---- one backend choice, no hidden fallback ----------------------------------------

@pytest.mark.parametrize("platform,want", [("gpu", "pallas"),
                                           ("cpu", "scan")])
def test_hit_backend_by_platform(platform, want):
    assert hit_backend(platform) == want


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_hit_backend_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no hit-finding implementation"):
        hit_backend(platform)


def test_hit_backend_default_is_this_process():
    assert hit_backend() == "scan"            # tests run on the CPU


def test_resolve_backend_explicit_and_auto():
    assert resolve_backend("auto") == "scan"
    for name in ("pallas", "scan", "reference"):
        assert resolve_backend(name) == name
    with pytest.raises(ValueError):
        resolve_backend("interpret")


def test_interpret_only_when_asked():
    """No processor turns the Pallas interpreter on by itself."""
    from fdreadoutlibs_jax.stream.protowib import WIBFrameProcessor
    from fdreadoutlibs_jax.stream.wibeth import WIBEthFrameProcessor
    for proc in (WIBEthFrameProcessor(), WIBFrameProcessor()):
        proc.conf({"enable_tpg": False, "tpg_backend": "pallas"})
        assert proc._interpret is False
        assert proc.backend == "pallas"


# ---- meshes raise instead of falling back -----------------------------------------

def test_link_mesh_too_few_devices_raises():
    from fdreadoutlibs_jax.parallel import make_link_mesh
    assert make_link_mesh(4).devices.size == 4
    with pytest.raises(RuntimeError, match="need 16"):
        make_link_mesh(16)


def test_apa_link_mesh_too_few_devices_raises():
    from fdreadoutlibs_jax.parallel import make_apa_link_mesh
    assert make_apa_link_mesh(2, 4).devices.shape == (2, 4)
    with pytest.raises(RuntimeError, match="need 12"):
        make_apa_link_mesh(3, 4)


# ---- compile cache ----------------------------------------------------------------

def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    import jax
    from fdreadoutlibs_jax.utils import runtime
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        got = runtime.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        with open(os.path.join(root, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    import jax
    from fdreadoutlibs_jax.utils import runtime
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == old   # nothing set


# ---- the kernel wrapper: layout, padding, shape contract --------------------------

@pytest.mark.parametrize("C,rows", [(1, 8), (128, 8), (1025, 16),
                                    (2560, 24)])
def test_pad_sublanes_granule(C, rows):
    assert P.pad_sublanes(C) == rows


@pytest.mark.parametrize("sub", [1, 2, 4, 8])
def test_pack_state_roundtrip_any_block(sub):
    C = 300
    rng = np.random.default_rng(sub)
    st = seed_chanstate(init_chanstate(C),
                        rng.integers(0, 1 << 14, C), 8)
    st["fir_prev"] = rng.integers(-100, 100, (P.N_FIR_TAPS, C))
    stack = P.pack_state(st, C, block_sublanes=sub)
    assert stack.shape == (8 // sub, P.KSTATE, sub, P.LANES)
    back = P.unpack_state(stack, C)
    for k in back:
        np.testing.assert_array_equal(back[k], np.asarray(st[k]), err_msg=k)
    with pytest.raises(ValueError):
        P.pack_state(st, C, block_sublanes=3)


def test_pack_adcs_pads_with_zeros_and_time2_roundtrips():
    rng = np.random.default_rng(2)
    adcs = rng.integers(0, 1 << 14, (64, 200)).astype(np.int32)
    packed = P.pack_adcs(adcs)
    assert packed.shape == (64, 8, P.LANES)
    flat = packed.reshape(64, -1)
    np.testing.assert_array_equal(flat[:, :200], adcs)
    assert not flat[:, 200:].any()
    t2 = P.pack_adcs_time2(adcs).reshape(32, -1)
    np.testing.assert_array_equal((t2 << 16) >> 16, flat[0::2])
    np.testing.assert_array_equal(t2 >> 16, flat[1::2])


@pytest.mark.parametrize("bad", ["tc", "unroll", "time2-odd-unroll",
                                 "rows", "dtype"])
def test_kernel_rejects_bad_shapes(bad):
    import jax.numpy as jnp
    cfg = TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=100)
    C, T = 128, 64
    st = seed_chanstate(init_chanstate(C), np.full(C, 900), 0)
    stack = P.pack_state(st, C, block_sublanes=8)
    adcs = jnp.asarray(P.pack_adcs(np.full((T, C), 900, np.int32)))
    kw = dict(tc=32, unroll=1, interpret=True)
    if bad == "tc":
        kw["tc"] = 48
    elif bad == "unroll":
        kw["unroll"] = 5
    elif bad == "time2-odd-unroll":
        adcs = adcs[: T // 2]
        kw["time_packed"] = True
    elif bad == "rows":           # state for 16 rows, ADCs for 8
        st = seed_chanstate(init_chanstate(2048), np.full(2048, 900), 0)
        stack = P.pack_state(st, 2048, block_sublanes=8)
    else:
        adcs = adcs.astype(jnp.int16)
    with pytest.raises(ValueError):
        P.process_window_pallas(adcs, stack, cfg, **kw)


# ---- chip_smoke.py: comparators and the result line -------------------------------

def test_chip_smoke_check_equal_exact():
    from fdreadoutlibs_jax.ops.hits import HIT_DTYPE
    a = np.zeros(3, HIT_DTYPE)
    a["channel"] = [1, 2, 3]
    chip_smoke.check_equal("same", a, a.copy())
    b = a.copy()
    b["charge"][1] = 1
    with pytest.raises(AssertionError, match="1 elements differ"):
        chip_smoke.check_equal("one field", b, a)
    with pytest.raises(AssertionError, match="shape/dtype"):
        chip_smoke.check_equal("length", a[:2], a)
    with pytest.raises(AssertionError, match="shape/dtype"):
        chip_smoke.check_equal("dtype", np.zeros(3, np.int64),
                               np.zeros(3, np.int32))


def test_chip_smoke_check_state_names_the_field():
    want = {"pedestals": np.arange(4), "fir_phase": 0}
    chip_smoke.check_state("s", {"pedestals": np.arange(4)}, want)
    with pytest.raises(AssertionError, match=r"state\[pedestals\]"):
        chip_smoke.check_state("s", {"pedestals": np.arange(4) + 1}, want)


def test_chip_smoke_result_line_format():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_chip_smoke_refuses_without_gpu(capsys):
    """On the CPU the script stops in phase 1 and prints no result."""
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert "no GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_four_cards_option_parses():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(["--four-cards"])
    assert "no GPU" in str(exc.value.code)


@pytest.mark.gpu
def test_kernel_compiles_on_gpu(gpu):
    """On a GPU, the compiled kernel matches the scan path (the full check
    at APA width is chip_smoke.py phase 2)."""
    chip_smoke.phase_kernel(T=512, C=640, n_windows=2, reps=1)
