"""CLI tool-chain and source-emulator tests (the reference's documented
validation workflow, docs/README.md:20-121)."""

import json

import numpy as np
import pytest

from fdreadoutlibs_jax.cli import main as cli_main
from fdreadoutlibs_jax.formats import wibeth
from fdreadoutlibs_jax.formats.adapters import get_adapter
from fdreadoutlibs_jax.models import MODEL_FAMILIES, get_model, run_model
from fdreadoutlibs_jax.ops import TPGConfig
from fdreadoutlibs_jax.stream.emulator import (FileSourceBuffer, RateLimiter,
                                               SourceEmulator,
                                               all_zeros_wibeth_file,
                                               pattern_file)
from fdreadoutlibs_jax.stream.transport import QueueSender


class TestModels:
    def test_registry(self):
        assert set(MODEL_FAMILIES) == {"SimpleThreshold", "AbsRS",
                                       "StandardRS", "FIR"}
        assert get_model("AbsRS").uses_rs_state
        with pytest.raises(Exception):
            get_model("NoSuchAlgorithm")

    def test_run_model_backends_agree(self):
        rng = np.random.default_rng(0)
        adcs = (900 + rng.normal(0, 20, size=(130, 32))).astype(np.int32)
        adcs[50:60, 3] += 900
        cfg = TPGConfig(threshold=200)
        h_ref, _ = run_model(adcs, cfg, backend="reference")
        h_scan, _ = run_model(adcs, cfg, backend="scan")
        h_pal, _ = run_model(adcs, cfg, backend="pallas", interpret=True)
        assert len(h_ref) >= 1
        np.testing.assert_array_equal(h_scan, h_ref)
        np.testing.assert_array_equal(h_pal, h_ref)


class TestEmulatorPieces:
    def test_file_source_buffer(self, tmp_path):
        path = tmp_path / "zeros.bin"
        all_zeros_wibeth_file(path, n_frames=8)
        buf = FileSourceBuffer(wibeth.FRAME_SIZE)
        payloads = buf.read(path)
        assert payloads.shape == (8, 7200)
        ts = wibeth.get_timestamp(payloads)
        assert (np.diff(ts.astype(np.int64)) == 2048).all()

    def test_rate_limiter(self):
        import time
        rl = RateLimiter(1000)
        t0 = time.monotonic()
        for _ in range(10):
            rl.limit()
        assert time.monotonic() - t0 >= 0.008

    def test_source_emulator_replay(self, tmp_path):
        path = tmp_path / "zeros.bin"
        all_zeros_wibeth_file(path, n_frames=4)
        buf = FileSourceBuffer(wibeth.FRAME_SIZE)
        payloads = buf.read(path)
        sink = QueueSender()
        emu = SourceEmulator(sink, adapter=get_adapter("wibeth"))
        emu.conf({"rate_hz": 100000, "batch_size": 4})
        emu.run(payloads, n_batches=3, first_timestamp=7000,
                tick_per_payload=2048)
        batches = sink.drain()
        assert emu.packets_sent == 12
        ts = np.concatenate([wibeth.get_timestamp(b) for b in batches])
        np.testing.assert_array_equal(
            ts, 7000 + 2048 * np.arange(12, dtype=np.uint64))


class TestCLI:
    def test_full_validation_workflow(self, tmp_path, capsys):
        zeros = tmp_path / "zeros.bin"
        assert cli_main(["make-zeros", "-o", str(zeros), "-n", "4"]) == 0

        patt = tmp_path / "golden.bin"
        assert cli_main(["pattern-generator", "-f", str(zeros), "-p", "golden",
                         "-n", "2", "-i", "5", "-o", "1",
                         "--output", str(patt)]) == 0

        tps = tmp_path / "tps.txt"
        assert cli_main(["tpg-emulator", "-f", str(patt),
                         "-a", "SimpleThreshold", "-i", "reference",
                         "-t", "499", "--save-trigprim", str(tps)]) == 0
        out = capsys.readouterr().out
        stats = json.loads(out.strip().splitlines()[-1])
        assert stats["hits"] == 2
        lines = tps.read_text().strip().splitlines()
        assert lines[0].startswith("channel,time_start")
        first = lines[1].split(",")
        assert int(first[4]) == 4528 and int(first[5]) == 506

        assert cli_main(["compare-backends", "-f", str(patt), "-t", "499",
                         "-b", "reference", "scan"]) == 0

        assert cli_main(["frame-reader", "-f", str(patt), "-n", "1"]) == 0

    def test_frame_modifier(self, tmp_path):
        zeros = tmp_path / "z.bin"
        cli_main(["make-zeros", "-o", str(zeros), "-n", "2"])
        out = tmp_path / "mod.bin"
        assert cli_main(["frame-modifier", "-f", str(zeros),
                         "--set-channel", "9", "--set-value", "777",
                         "--output", str(out)]) == 0
        frames = np.fromfile(out, dtype=np.uint8).reshape(-1, 7200)
        assert (wibeth.get_adcs(frames)[..., 9] == 777).all()
        assert (wibeth.get_adcs(frames)[..., 8] == 0).all()


class TestCompareTpFiles:
    def test_match_and_mismatch(self, tmp_path, capsys):
        a = tmp_path / "a.txt"
        b = tmp_path / "b.txt"
        hdr = "channel,time_start,time_over_threshold,time_peak,adc_integral,adc_peak,type\n"
        a.write_text(hdr + "1,100,32,110,500,250,1\n2,200,64,220,900,400,1\n")
        b.write_text(hdr + "2,200,64,220,900,400,1\n1,100,32,110,500,250,1\n")
        assert cli_main(["compare-tp-files", str(a), str(b)]) == 0
        b.write_text(hdr + "1,100,32,110,500,250,1\n")
        assert cli_main(["compare-tp-files", str(a), str(b)]) == 1


class TestProfile:
    def test_profile_writes_trace(self, tmp_path, capsys):
        """`cli profile` captures a jax.profiler trace dir + prints stats."""
        out = tmp_path / "trace"
        assert cli_main(["profile", "-a", "SimpleThreshold",
                         "--channels", "128", "--ticks", "64",
                         "--windows", "2", "-o", str(out)]) == 0
        import json as _json
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
        rep = _json.loads(lines[-1])
        assert rep["windows"] == 2 and rep["gsps_wall"] > 0
        # trace dir exists and holds at least one profile artifact
        files = list(out.rglob("*"))
        assert any(f.is_file() for f in files), files

    def test_profile_summary(self, tmp_path, capsys):
        out = tmp_path / "trace"
        assert cli_main(["profile", "-a", "AbsRS", "--channels", "128",
                         "--ticks", "64", "--windows", "1",
                         "-o", str(out), "--top", "5"]) == 0
        text = capsys.readouterr().out
        assert "# top ops by total device/host time" in text
