"""All documented validation patterns through the full WIBEth processor
(docs/README.md:123-146 of the reference; docs/README.md here)."""

import numpy as np
import pytest

from fdreadoutlibs_jax.formats import wibeth
from fdreadoutlibs_jax.ops import patterns
from fdreadoutlibs_jax.stream import WIBEthFrameProcessor
from fdreadoutlibs_jax.stream.transport import QueueSender

TS0 = 0x66583B8C7E967


def run_pattern(name, threshold, **kw):
    frames, adcs = patterns.pattern_frames(
        name, first_timestamp=TS0, crate_id=1, slot_id=2, stream_id=3, **kw)
    wibeth.fake_seq_ids(frames, 0)
    sink = QueueSender()
    proc = WIBEthFrameProcessor(tp_sink=sink)
    proc.conf({"crate_id": 1, "slot_id": 2, "link_id": 3, "enable_tpg": True,
               "tpg_threshold": threshold, "tp_timeout": 100_000,
               "tpg_backend": "reference"})
    proc.start()
    proc.process(frames)
    out = sink.drain()
    tps = np.concatenate(out) if out else np.zeros(0)
    return tps, proc


class TestPatternCatalog:
    def test_golden(self):
        tps, proc = run_pattern("golden", 499, n_frames=2, channel=0, offset=1)
        assert len(tps) == 2
        assert tps["adc_integral"].tolist() == [4528, 4021]
        assert tps["adc_peak"].tolist() == [506, 505]
        assert tps["time_start"][0] == TS0 + 32 * 1
        assert tps["time_peak"][0] == TS0 + 32 * 5

    def test_pulse(self):
        tps, _ = run_pattern("pulse", 499, n_frames=2, channel=9, tick=20,
                             amplitude=5000)
        assert len(tps) == 1
        assert tps["adc_integral"][0] == 5000
        assert tps["time_over_threshold"][0] == 32
        assert tps["time_start"][0] == TS0 + 32 * 20

    def test_edge_square(self):
        tps, _ = run_pattern("edge_square", 499, n_frames=2, channel=3,
                             amplitude=1000, width=16)
        assert len(tps) == 1
        # spans the frame boundary: starts in frame 0, ends in frame 1
        assert tps["time_start"][0] == TS0 + 32 * 56
        assert tps["time_start"][0] < TS0 + 2048 < \
            tps["time_start"][0] + tps["time_over_threshold"][0]
        assert tps["adc_integral"][0] == 10 * 1000 + 6 * 999

    def test_edge_left_peak_in_first_frame(self):
        tps, _ = run_pattern("edge_left", 400, n_frames=2, channel=5,
                             amplitude=1000)
        assert len(tps) == 1
        assert tps["time_peak"][0] == TS0 + 32 * 61      # peak tick 61
        assert tps["time_peak"][0] < TS0 + 2048          # in frame 0

    def test_edge_right_peak_in_second_frame(self):
        tps, _ = run_pattern("edge_right", 400, n_frames=2, channel=5,
                             amplitude=1000)
        assert len(tps) == 1
        assert tps["time_peak"][0] == TS0 + 32 * 66      # peak tick 66
        assert tps["time_peak"][0] > TS0 + 2048          # in frame 1

    @pytest.mark.parametrize("name", list(patterns.PATTERNS))
    def test_quiet_background_no_extra_tps(self, name):
        """Every pattern produces TPs only on its target channel."""
        kw = {"n_frames": 2, "channel": 11}
        tps, _ = run_pattern(name, 400, **kw)
        if len(tps):
            base = int(tps["channel"][0])
            assert (tps["channel"] == base).all()
