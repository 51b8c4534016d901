"""Kernel launch parameters and the tuned-file override (utils/tuning.py)."""

import json

import numpy as np
import pytest

from fdreadoutlibs_jax.ops import Algorithm, TPGConfig
from fdreadoutlibs_jax.utils import tuning


@pytest.fixture(autouse=True)
def _clear_cache(monkeypatch):
    tuning._cache.clear()
    monkeypatch.delenv("FDREADOUT_TUNED", raising=False)
    yield
    tuning._cache.clear()


def write_tuned(tmp_path, data):
    p = tmp_path / "tuned.json"
    p.write_text(json.dumps(data))
    return str(p)


class TestKernelKnobs:
    def test_defaults_without_file(self):
        cfg = TPGConfig(threshold=150)
        k = tuning.kernel_knobs(cfg, 2560, tc=512, unroll=32)
        assert k == {"tc": 512, "unroll": 32, "k_slots": 1,
                     "block_sublanes": 1, "num_warps": 4, "num_stages": 1}

    def test_shipped_table_governs(self):
        from fdreadoutlibs_jax.utils.tuning import KERNEL_KNOBS
        cfg = TPGConfig(algorithm=Algorithm.FIR, threshold=5)
        k = tuning.kernel_knobs(cfg, 2560)
        shipped = KERNEL_KNOBS[Algorithm.FIR]
        assert k["tc"] == shipped["tc"]
        assert k["unroll"] == shipped["unroll"]
        assert k["block_sublanes"] == shipped["sub"]
        assert k["num_warps"] == shipped["num_warps"]
        assert k["num_stages"] == shipped["num_stages"]

    def test_tuned_file_overrides(self, tmp_path, monkeypatch):
        path = write_tuned(tmp_path, {"AbsRS": {"sub": 8, "tc": 128,
                                                "unroll": 16,
                                                "num_warps": 2,
                                                "num_stages": 3}})
        monkeypatch.setenv("FDREADOUT_TUNED", path)
        cfg = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=150)
        k = tuning.kernel_knobs(cfg, 2560)
        assert k == {"tc": 128, "unroll": 16, "k_slots": 1,
                     "block_sublanes": 8, "num_warps": 2, "num_stages": 3}
        # explicit arguments beat the tuned file (documented precedence)
        k_exp = tuning.kernel_knobs(cfg, 2560, tc=512, unroll=32)
        assert k_exp["tc"] == 512 and k_exp["unroll"] == 32
        # other algorithms keep their defaults
        k2 = tuning.kernel_knobs(TPGConfig(threshold=150), 2560)
        assert k2 == tuning.kernel_knobs(TPGConfig(threshold=150), 2560,
                                         path="/nonexistent.json")

    def test_tuned_k_slots(self, tmp_path, monkeypatch):
        path = write_tuned(tmp_path, {"AbsRS": {"k": 2}})
        monkeypatch.setenv("FDREADOUT_TUNED", path)
        cfg = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=150)
        assert tuning.kernel_knobs(cfg, 2560)["k_slots"] == 2
        # other fields still fall back to shipped
        assert tuning.kernel_knobs(cfg, 2560)["tc"] == \
            tuning.KERNEL_KNOBS[Algorithm.ABS_RS]["tc"]

    @pytest.mark.parametrize("sub", [3, 6, 16, 0])
    def test_granule_violating_sub_falls_back(self, tmp_path, monkeypatch,
                                              sub):
        # the channel block must be a power of two dividing the 8-row
        # container granule, or a tuned file could crash the kernel
        path = write_tuned(tmp_path, {"FIR": {"sub": sub}})
        monkeypatch.setenv("FDREADOUT_TUNED", path)
        cfg = TPGConfig(algorithm=Algorithm.FIR, threshold=5)
        k = tuning.kernel_knobs(cfg, 2560)
        assert k["block_sublanes"] == tuning.KERNEL_KNOBS[Algorithm.FIR]["sub"]

    def test_mtime_cache_picks_up_rewrites(self, tmp_path, monkeypatch):
        path = write_tuned(tmp_path, {"AbsRS": {"tc": 128}})
        monkeypatch.setenv("FDREADOUT_TUNED", path)
        cfg = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=150)
        assert tuning.kernel_knobs(cfg, 2560)["tc"] == 128
        import os
        import time as _t
        _t.sleep(0.01)
        write_tuned(tmp_path, {"AbsRS": {"tc": 64}})
        os.utime(path)                              # ensure mtime moves
        assert tuning.kernel_knobs(cfg, 2560)["tc"] == 64

    def test_unreadable_file_ignored(self, tmp_path, monkeypatch):
        p = tmp_path / "bad.json"
        p.write_text("{not json")
        monkeypatch.setenv("FDREADOUT_TUNED", str(p))
        k = tuning.kernel_knobs(TPGConfig(threshold=150), 2560)
        assert k["tc"] == tuning.KERNEL_KNOBS[Algorithm.SIMPLE_THRESHOLD]["tc"]

    def test_malformed_fields_fall_back_per_field(self, tmp_path,
                                                  monkeypatch):
        """Bad tuned values must never crash deployment — each field
        falls back independently (kernel_knobs docs)."""
        cfg = TPGConfig(algorithm=Algorithm.FIR, threshold=5)
        shipped = tuning.KERNEL_KNOBS[Algorithm.FIR]
        for bad in ({"tc": None}, {"tc": "512"}, {"sub": "8"},
                    {"sub": -8}, {"unroll": 0}, {"tc": True},
                    {"num_warps": 0}, {"num_stages": "2"}, "notadict"):
            tuning._cache.clear()
            path = write_tuned(tmp_path, {"FIR": bad})
            monkeypatch.setenv("FDREADOUT_TUNED", path)
            k = tuning.kernel_knobs(cfg, 2560)
            assert k["tc"] == shipped["tc"], bad
            assert k["unroll"] == shipped["unroll"], bad
            assert k["block_sublanes"] == shipped["sub"], bad
            assert k["num_warps"] == shipped["num_warps"], bad
            assert k["num_stages"] == shipped["num_stages"], bad
        # a good field next to a bad one still applies
        tuning._cache.clear()
        path = write_tuned(tmp_path, {"FIR": {"tc": 128, "unroll": None}})
        monkeypatch.setenv("FDREADOUT_TUNED", path)
        k = tuning.kernel_knobs(cfg, 2560)
        assert k["tc"] == 128 and k["unroll"] == shipped["unroll"]


class TestStreamingIngestPickup:
    def test_ingest_uses_tuned_knobs(self, tmp_path, monkeypatch):
        from fdreadoutlibs_jax.ops.ingest import StreamingIngest
        path = write_tuned(tmp_path, {"SimpleThreshold":
                                      {"sub": 2, "tc": 128, "unroll": 4}})
        monkeypatch.setenv("FDREADOUT_TUNED", path)
        ing = StreamingIngest(TPGConfig(threshold=150), n_links=1,
                              interpret=True)
        assert ing.tc == 128 and ing.unroll == 4
        # explicit arguments still win over the tuned file
        ing2 = StreamingIngest(TPGConfig(threshold=150), n_links=1,
                               tc=64, unroll=2, interpret=True)
        assert ing2.tc == 64 and ing2.unroll == 2

    def test_ingest_hits_unchanged_by_tuning(self, tmp_path, monkeypatch):
        """Knobs change scheduling only — hit output is identical."""
        from fdreadoutlibs_jax.formats import wibeth
        from fdreadoutlibs_jax.ops.ingest import StreamingIngest

        rng = np.random.default_rng(3)
        frames = wibeth.empty_frames(2)
        adcs = (800 + rng.normal(0, 20, size=(2, 64, 64))).astype(np.uint16)
        adcs[0, 20:28, 9] += 2000
        wibeth.set_adcs(frames, adcs)
        batch = frames[None]                     # one link

        def run():
            ing = StreamingIngest(TPGConfig(threshold=120), n_links=1,
                                  interpret=True)
            ing.submit(batch)
            return ing.flush()

        h_default = run()
        path = write_tuned(tmp_path, {"SimpleThreshold":
                                      {"tc": 64, "unroll": 1}})
        monkeypatch.setenv("FDREADOUT_TUNED", path)
        tuning._cache.clear()
        h_tuned = run()
        np.testing.assert_array_equal(h_default[0], h_tuned[0])
        assert len(h_default[0]) > 0

    def test_fir_launch_params_hits_unchanged(self, tmp_path, monkeypatch):
        """A tuned channel block flows end-to-end through StreamingIngest
        and changes NOTHING about the hits or the state (launch geometry,
        not physics)."""
        from fdreadoutlibs_jax.formats import wibeth
        from fdreadoutlibs_jax.ops.ingest import StreamingIngest

        rng = np.random.default_rng(5)
        frames = wibeth.empty_frames(2)
        adcs = (800 + rng.normal(0, 4, size=(2, 64, 64))).astype(np.uint16)
        adcs[0, 20:28, 9] += 400
        wibeth.set_adcs(frames, adcs)
        batch = frames[None]                     # one link
        cfg = TPGConfig(algorithm=Algorithm.FIR, threshold=5,
                        track_peaks=False)

        def run():
            ing = StreamingIngest(cfg, n_links=1, interpret=True)
            ing.submit(batch)
            return ing.flush(), np.asarray(ing.stack)

        (h_default, _), st_default = run()
        path = write_tuned(tmp_path, {"FIR": {"sub": 8, "num_warps": 2}})
        monkeypatch.setenv("FDREADOUT_TUNED", path)
        tuning._cache.clear()
        (h_tuned, _), st_tuned = run()
        np.testing.assert_array_equal(h_default, h_tuned)
        assert st_default.shape[2] == 1 and st_tuned.shape[2] == 8
        np.testing.assert_array_equal(
            st_default.transpose(1, 0, 2, 3).reshape(st_default.shape[1], -1),
            st_tuned.transpose(1, 0, 2, 3).reshape(st_tuned.shape[1], -1))
        assert len(h_default) > 0
