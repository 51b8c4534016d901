"""HD APA channel map (production detector geometry) tests.

The reference resolves geometry via detchannelmaps (PD2HDChannelMap,
RegisterToChannelNumber.cpp:49-50); the rebuild derives the HD APA map from
the documented electronics geometry (utils/channel_map.HDAPAChannelMap).
"""

import numpy as np
import pytest

from fdreadoutlibs_jax.utils.channel_map import (
    HDAPAChannelMap, TableChannelMap, make_map, register_map_via_expansion)


class TestHDAPAChannelMap:
    def test_full_apa_coverage_bijective(self):
        """All 5 WIBs x 8 streams x 64 channels cover exactly offline
        [0, 2560) with no duplicates."""
        m = HDAPAChannelMap()
        seen = []
        for slot in range(5):
            for stream in range(8):
                seen.append(m.offline_channels(0, slot, stream, 64))
        seen = np.concatenate(seen)
        assert len(seen) == 2560
        np.testing.assert_array_equal(np.sort(seen), np.arange(2560))

    def test_plane_boundaries(self):
        """Known HD APA plane blocks: U=[0,800) V=[800,1600) X=[1600,2560);
        0 = collection in this framework's convention."""
        m = HDAPAChannelMap()
        planes = m.planes(np.arange(2560))
        assert (planes[:800] == 1).all()          # induction U
        assert (planes[800:1600] == 2).all()      # induction V
        assert (planes[1600:] == 0).all()         # collection X
        # counts are the physical wire counts
        assert (planes == 0).sum() == 960
        assert (planes == 1).sum() == 800
        assert (planes == 2).sum() == 800

    def test_femb_structure(self):
        """Each FEMB (two consecutive streams) reads 40 U + 40 V + 48 X."""
        m = HDAPAChannelMap()
        for slot in range(5):
            for femb in range(4):
                offl = np.concatenate([
                    m.offline_channels(0, slot, femb * 2, 64),
                    m.offline_channels(0, slot, femb * 2 + 1, 64)])
                planes = m.planes(offl)
                assert (planes == 1).sum() == 40
                assert (planes == 2).sum() == 40
                assert (planes == 0).sum() == 48

    def test_wib2_frontend_bijective_and_consistent_with_wibeth(self):
        """WIB2 geometry (2 links x 256 ch per WIB) covers the same APA:
        all 5 WIBs x 2 links x 256 channels hit offline [0, 2560) exactly
        once, and each (femb, in-FEMB channel) resolves to the SAME offline
        number as through the WIBEth half-FEMB streams (same electronics,
        different framing)."""
        m2 = HDAPAChannelMap(frontend="wib2")
        me = HDAPAChannelMap()
        seen = []
        for slot in range(5):
            for link in range(2):
                offl = m2.offline_channels(0, slot, link, 256)
                seen.append(offl)
                # frame channel c = (femb-in-link)*128 + femb_chan; the
                # WIBEth equivalent stream is femb*2 + femb_chan//64
                for c in (0, 63, 64, 127, 128, 200, 255):
                    femb_in_wib = link * 2 + c // 128
                    femb_chan = c % 128
                    stream = femb_in_wib * 2 + femb_chan // 64
                    assert offl[c] == \
                        me.get_offline_channel_from_crate_slot_stream_chan(
                            0, slot, stream, femb_chan % 64)
        seen = np.concatenate(seen)
        np.testing.assert_array_equal(np.sort(seen), np.arange(2560))

    def test_wib2_frontend_guards(self):
        import pytest
        m2 = HDAPAChannelMap(frontend="wib2")
        with pytest.raises(ValueError, match="256"):
            m2.get_offline_channel_from_crate_slot_stream_chan(0, 0, 2, 0)
        with pytest.raises(ValueError, match="unknown frontend"):
            HDAPAChannelMap(frontend="tde")

    def test_wib2_processor_runs_with_hd_map(self):
        """End-to-end: the WIB2 processor configured with the HD APA map
        (frontend='wib2') assigns production memory factors from the real
        plane split and emits TPs with real offline channel numbers."""
        from fdreadoutlibs_jax.formats import wib2
        from fdreadoutlibs_jax.stream.transport import QueueSender
        from fdreadoutlibs_jax.stream.wib2 import WIB2FrameProcessor

        sink = QueueSender()
        p = WIB2FrameProcessor(tp_sink=sink)
        p.conf({"crate_id": 0, "slot_id": 1, "link_id": 1,
                "enable_tpg": True, "tpg_algorithm": "AbsRS",
                "tpg_threshold": 150, "tpg_backend": "scan",
                "channel_map_name": "HDAPAChannelMap",
                "channel_map_args": {"frontend": "wib2"},
                "enable_simple_threshold_on_collection": True})
        p.start()
        n_super = 4
        sc = wib2.empty_superchunks(n_super)
        frames = wib2.superchunk_frames(sc)
        wib2.fake_timestamps(sc, 1000)
        wib2.fake_geoid(sc, 0, 1, 1)
        adcs = np.full((n_super * 12, wib2.N_CHANNELS), 820, np.uint16)
        adcs[10:30, 7] += 900                     # one clear pulse
        wib2.set_adcs(frames.reshape(-1, wib2.FRAME_SIZE), adcs)
        p.process(sc)
        m2 = HDAPAChannelMap(frontend="wib2")
        expected = m2.offline_channels(0, 1, 1, 256)
        planes = m2.planes(expected)
        np.testing.assert_array_equal(
            p.register_memory_factor == 0, planes == 0)
        tps = [tp for b in sink.drain() for tp in b]
        assert len(tps) >= 1
        chans = {int(t["channel"]) for t in tps}
        assert chans <= set(expected.tolist())
        assert int(expected[7]) in chans

    def test_crate_is_apa_offset(self):
        m = HDAPAChannelMap()
        a0 = m.offline_channels(0, 2, 3, 64)
        a2 = m.offline_channels(2, 2, 3, 64)
        np.testing.assert_array_equal(a2 - a0, 2 * 2560)
        assert m.get_plane_from_offline_channel(2 * 2560 + 1700) == 0

    def test_registry_aliases_resolve_to_hd_map(self):
        assert isinstance(make_map("PD2HDChannelMap"), HDAPAChannelMap)
        assert isinstance(make_map("HDColdboxChannelMap"), HDAPAChannelMap)

    def test_expansion_roundtrip_through_real_codec(self):
        """The reference's RegisterToChannelNumber trick: push offline
        numbers through the real frame pack/unpack and read where they
        land (RegisterToChannelNumber.cpp:35-122)."""
        m = HDAPAChannelMap()
        offl = register_map_via_expansion(m, crate=1, slot=3, stream=5)
        np.testing.assert_array_equal(offl, m.offline_channels(1, 3, 5, 64))

    def test_custom_femb_table(self):
        """The in-FEMB ASIC-order table is injectable data: a permuted
        table changes channel order but keeps the plane structure."""
        rng = np.random.default_rng(3)
        table = HDAPAChannelMap.default_femb_table()[rng.permutation(128)]
        m = HDAPAChannelMap(femb_table=table)
        seen = np.concatenate([m.offline_channels(0, s, st, 64)
                               for s in range(5) for st in range(8)])
        np.testing.assert_array_equal(np.sort(seen), np.arange(2560))


class TestTableMapLoader:
    def test_from_file_translates_dune_plane_convention(self, tmp_path):
        """Real detchannelmaps files use 0=U/1=V/2=collection; the loader
        translates into this framework's 0=collection convention."""
        p = tmp_path / "map.txt"
        lines = ["# offline crate slot stream chan plane"]
        for ch in range(64):
            dune_plane = 2 if ch < 48 else 0     # collection then U
            lines.append(f"{1000 + ch} 0 1 2 {ch} {dune_plane}")
        p.write_text("\n".join(lines))
        m = TableChannelMap.from_file(p)
        np.testing.assert_array_equal(
            m.offline_channels(0, 1, 2, 64), 1000 + np.arange(64))
        assert m.get_plane_from_offline_channel(1010) == 0  # collection
        assert m.get_plane_from_offline_channel(1050) == 1  # U induction

    def test_from_file_native_convention(self, tmp_path):
        p = tmp_path / "map.txt"
        p.write_text("\n".join(f"{100 + ch} 0 0 0 {ch} 0"
                               for ch in range(64)))
        m = TableChannelMap.from_file(p, plane_convention="native")
        assert m.get_plane_from_offline_channel(100) == 0


class TestGuards:
    def test_hd_map_rejects_256_channel_queries(self):
        """WIB2-style 256-channel frontends must not silently truncate
        through the 64-channel HD APA geometry."""
        import pytest
        m = HDAPAChannelMap()
        with pytest.raises(ValueError, match="64 channels"):
            m.offline_channels(0, 0, 0, 256)
        with pytest.raises(ValueError, match="wib2"):
            m.get_offline_channel_from_crate_slot_stream_chan(0, 0, 0, 100)

    def test_mf_shift_promise_validated(self):
        """Per-channel memory factors outside {0, 1<<shift} are rejected
        loudly instead of silently computing wrong RS values."""
        import pytest
        from fdreadoutlibs_jax.ops import TPGConfig
        from fdreadoutlibs_jax.ops.reference import run_reference
        cfg = TPGConfig.from_raw("AbsRS", threshold=150)  # rs_mf_shift=3
        adcs = np.full((8, 4), 900, np.int32)
        with pytest.raises(ValueError, match="rs_mf_shift"):
            run_reference(adcs, cfg, rs_memory_factor=np.array([0, 8, 6, 8]))
        # the promised set passes
        run_reference(adcs, cfg, rs_memory_factor=np.array([0, 8, 0, 8]))
        # arbitrary factors work with the generic config
        gen = TPGConfig.from_raw("AbsRS", threshold=150, rs_mf_shift=None)
        run_reference(adcs, gen, rs_memory_factor=np.array([0, 8, 6, 8]))

    def test_wib2_fir_drops_peak_tracking_daphne_keeps_it(self):
        from fdreadoutlibs_jax.stream.wib2 import WIB2FrameProcessor
        from fdreadoutlibs_jax.stream.daphne import DAPHNEStreamFrameProcessor
        w = WIB2FrameProcessor()
        w.conf({"enable_tpg": True, "tpg_algorithm": "FIR",
                "tpg_threshold": 5})
        assert w.tpg_cfg.track_peaks is False
        d = DAPHNEStreamFrameProcessor()
        d.conf({"enable_tpg": True})
        assert d.tpg_cfg.track_peaks is True


class TestCLI:
    def test_channel_map_dump(self, capsys):
        from fdreadoutlibs_jax.cli import main as cli_main
        assert cli_main(["channel-map", "--slot", "1", "--stream", "3",
                         "--json", "--channels", "8"]) == 0
        import json
        out = json.loads(capsys.readouterr().out.strip())
        m = HDAPAChannelMap()
        assert out["offline"] == m.offline_channels(0, 1, 3, 8).tolist()


class TestProcessorIntegration:
    def test_threshold_on_collection_memory_factors(self):
        """The WIBEth processor zeroes RS memory factors exactly on the
        collection-plane channels of its stream (WIBEthFrameProcessor.cpp:
        441-450) with the HD map."""
        from fdreadoutlibs_jax.formats import wibeth
        from fdreadoutlibs_jax.stream import WIBEthFrameProcessor
        from fdreadoutlibs_jax.stream.transport import QueueSender

        p = WIBEthFrameProcessor(tp_sink=QueueSender())
        p.conf({"crate_id": 0, "slot_id": 1, "link_id": 2,
                "enable_tpg": True, "tpg_algorithm": "AbsRS",
                "tpg_threshold": 150, "tpg_backend": "scan",
                "channel_map_name": "HDAPAChannelMap",
                "enable_simple_threshold_on_collection": True})
        p.start()
        frames = wibeth.empty_frames(2)
        adcs = np.full((2, 64, 64), 800, np.uint16)
        adcs[1, 10:20, 5] += 3000
        wibeth.set_adcs(frames, adcs)
        wibeth.fake_timestamps(frames, 9000)
        wibeth.fake_geoid(frames, 0, 1, 2)
        p.process(frames)
        m = HDAPAChannelMap()
        offl = m.offline_channels(0, 1, 2, 64)
        planes = m.planes(offl)
        np.testing.assert_array_equal(
            p.register_memory_factor,
            np.where(planes == 0, 0, p.tpg_cfg.rs_memory_factor_x10))
        np.testing.assert_array_equal(p.register_channels, offl)


class TestVDTDEChannelMap:
    def test_crp_coverage_bijective(self):
        from fdreadoutlibs_jax.utils.channel_map import VDTDEChannelMap
        m = VDTDEChannelMap()
        seen = set()
        for crate in range(4):
            for slot in range(12):
                offl = m.offline_channels(crate, slot, 0)
                seen.update(offl.tolist())
        assert seen == set(range(3072))
        # second CRP offsets by 3072
        assert m.get_offline_channel_from_crate_slot_stream_chan(
            4, 0, 0, 0) == 3072

    def test_plane_split_sizes(self):
        from fdreadoutlibs_jax.utils.channel_map import VDTDEChannelMap
        m = VDTDEChannelMap()
        planes = m.planes(np.arange(3072))
        assert int(np.sum(planes == 1)) == 952     # induction-1
        assert int(np.sum(planes == 2)) == 952     # induction-2
        assert int(np.sum(planes == 0)) == 1168    # collection

    def test_permutation_injection_and_validation(self):
        from fdreadoutlibs_jax.utils.channel_map import VDTDEChannelMap
        perm = np.arange(3072)[::-1]
        m = VDTDEChannelMap(permutation=perm)
        assert m.get_offline_channel_from_crate_slot_stream_chan(
            0, 0, 0, 0) == 3071
        with pytest.raises(ValueError, match="permutation"):
            VDTDEChannelMap(permutation=np.zeros(3072, dtype=int))
        with pytest.raises(ValueError, match="geometry mismatch"):
            VDTDEChannelMap(n_slots=10)

    def test_registry(self):
        from fdreadoutlibs_jax.utils.channel_map import (VDTDEChannelMap,
                                                         make_map)
        assert isinstance(make_map("VDTopChannelMap"), VDTDEChannelMap)

    def test_offline_channels_validates_geometry(self):
        """The vectorized accessor (the TDEFrameProcessor path) enforces
        the same slot/crate ranges as the scalar one — an out-of-range
        slot must not silently alias into another AMC's channels."""
        from fdreadoutlibs_jax.utils.channel_map import VDTDEChannelMap
        m = VDTDEChannelMap()
        with pytest.raises(ValueError, match="slot"):
            m.offline_channels(0, 12, 0)            # n_slots == 12
        with pytest.raises(ValueError, match="slot"):
            m.offline_channels(0, -1, 0)
        with pytest.raises(ValueError, match="crate"):
            m.offline_channels(-1, 0, 0)
        with pytest.raises(ValueError, match="n_channels"):
            m.offline_channels(0, 0, 0, n_channels=65)


class TestFidelityHarness:
    def _write_dump(self, path, ch_map, crate=0, perturb=None):
        """Write a detchannelmaps-format dump from a map (offline crate
        slot stream chan plane, DUNE plane convention)."""
        native_to_dune = {1: 0, 2: 1, 0: 2}
        with open(path, "w") as f:
            f.write("# offline crate slot stream chan plane\n")
            for slot in range(5):
                for stream in range(8):
                    offl = ch_map.offline_channels(crate, slot, stream, 64)
                    for chan, off in enumerate(offl.tolist()):
                        if perturb and (slot, stream, chan) in perturb:
                            off = perturb[(slot, stream, chan)]
                        plane = native_to_dune[
                            ch_map.get_plane_from_offline_channel(off)
                            if not perturb else
                            HDAPAChannelMap().get_plane_from_offline_channel(off)]
                        f.write(f"{off} {crate} {slot} {stream} "
                                f"{chan} {plane}\n")

    def test_cross_check_confirms_matching_dump(self, tmp_path):
        from fdreadoutlibs_jax.utils.channel_map import (TableChannelMap,
                                                         cross_check_maps)
        geo = HDAPAChannelMap()
        p = tmp_path / "dump.txt"
        self._write_dump(p, geo)
        tbl = TableChannelMap.from_file(p)
        keys = [(0, s, st) for s in range(5) for st in range(8)]
        rep = cross_check_maps(tbl, geo, keys)
        assert rep["match"] and rep["n_checked"] == 2560
        assert rep["n_offline_mismatch"] == 0

    def test_cross_check_pins_exact_divergence(self, tmp_path):
        from fdreadoutlibs_jax.utils.channel_map import (TableChannelMap,
                                                         cross_check_maps)
        geo = HDAPAChannelMap()
        p = tmp_path / "dump.txt"
        # swap two offline numbers in one stream
        a = int(geo.offline_channels(0, 2, 3, 64)[10])
        b = int(geo.offline_channels(0, 2, 3, 64)[11])
        self._write_dump(p, geo, perturb={(2, 3, 10): b, (2, 3, 11): a})
        tbl = TableChannelMap.from_file(p)
        keys = [(0, s, st) for s in range(5) for st in range(8)]
        rep = cross_check_maps(tbl, geo, keys)
        assert not rep["match"] and rep["n_offline_mismatch"] == 2
        locs = {(m["slot"], m["stream"], m["chan"])
                for m in rep["mismatches"]}
        assert locs == {(2, 3, 10), (2, 3, 11)}

    def test_femb_table_derivation_roundtrip(self, tmp_path):
        """A dump that fits the per-FEMB parametrization derives a
        femb_table that reproduces it exactly."""
        from fdreadoutlibs_jax.utils.channel_map import (cross_check_maps,
                                                         femb_table_from_dump)
        # a non-default but FEMB-uniform table: interleave the planes
        plane = np.concatenate([np.full(40, 1), np.full(40, 2),
                                np.full(48, 0)])
        idx = np.concatenate([np.arange(40), np.arange(40), np.arange(48)])
        order = np.argsort(np.arange(128) % 3, kind="stable")
        table = np.stack([plane, idx], axis=1)[order]
        truth = HDAPAChannelMap(femb_table=table)
        p = tmp_path / "dump.txt"
        self._write_dump(p, truth)
        derived = femb_table_from_dump(str(p))
        np.testing.assert_array_equal(derived, table)
        keys = [(0, s, st) for s in range(5) for st in range(8)]
        rep = cross_check_maps(HDAPAChannelMap(femb_table=derived), truth,
                               keys)
        assert rep["match"]

    def test_femb_table_derivation_rejects_nonuniform(self, tmp_path):
        from fdreadoutlibs_jax.utils.channel_map import femb_table_from_dump
        geo = HDAPAChannelMap()
        p = tmp_path / "dump.txt"
        # swap across FEMBs so no single femb_table can fit
        a = int(geo.offline_channels(0, 0, 0, 64)[0])   # femb 0
        b = int(geo.offline_channels(0, 1, 0, 64)[0])   # femb 4
        self._write_dump(p, geo, perturb={(0, 0, 0): b, (1, 0, 0): a})
        with pytest.raises(ValueError, match="FEMB"):
            femb_table_from_dump(str(p))


class TestTDEOfflineChannels:
    def test_tde_processor_resolves_offline_channels(self):
        """TDE TPs carry VD offline channels when a map is configured."""
        from fdreadoutlibs_jax.formats import tde
        from fdreadoutlibs_jax.stream.tde import TDEFrameProcessor
        from fdreadoutlibs_jax.stream.transport import QueueSender
        from fdreadoutlibs_jax.utils.channel_map import VDTDEChannelMap

        sink = QueueSender()
        p = TDEFrameProcessor(tp_sink=sink)
        p.conf({"enable_tpg": True, "tpg_threshold": 400,
                "channel_map_name": "VDTDEChannelMap",
                "crate_id": 1, "slot_id": 2, "link_id": 0})
        p.start()
        frames = tde.empty_frames(64)
        tde.set_channel(frames, np.arange(64))
        tde.fake_timestamps(frames, 5000)
        samples = np.full((64, tde.TOT_ADC16_SAMPLES), 700, np.uint16)
        samples[13, 100:110] += 2000                   # pulse on channel 13
        tde.set_adc_samples(frames, samples)
        p.process(frames)
        tps = np.concatenate(sink.drain())
        m = VDTDEChannelMap()
        expect = m.get_offline_channel_from_crate_slot_stream_chan(
            1, 2, 0, 13)
        assert expect in set(tps["channel"].tolist())


class TestValidateMapCLI:
    def test_validate_map_roundtrip(self, tmp_path, capsys):
        import json as _json
        from fdreadoutlibs_jax.cli import main as cli_main
        geo = HDAPAChannelMap()
        p = tmp_path / "dump.txt"
        TestFidelityHarness._write_dump(TestFidelityHarness(), p, geo)
        rc = cli_main(["validate-map", "-f", str(p),
                       "--derive-femb-table"])
        out = _json.loads(capsys.readouterr().out.strip())
        assert rc == 0 and out["match"] and out["derived_matches"]
        np.testing.assert_array_equal(
            np.array(out["femb_table"]),
            HDAPAChannelMap.default_femb_table())

    def test_validate_map_divergence_exit_code(self, tmp_path, capsys):
        import json as _json
        from fdreadoutlibs_jax.cli import main as cli_main
        geo = HDAPAChannelMap()
        a = int(geo.offline_channels(0, 2, 3, 64)[10])
        b = int(geo.offline_channels(0, 2, 3, 64)[11])
        p = tmp_path / "dump.txt"
        TestFidelityHarness._write_dump(
            TestFidelityHarness(), p, geo,
            perturb={(2, 3, 10): b, (2, 3, 11): a})
        rc = cli_main(["validate-map", "-f", str(p)])
        out = _json.loads(capsys.readouterr().out.strip())
        assert rc == 1 and not out["match"]
        assert out["n_offline_mismatch"] == 2

    def test_validate_map_divergent_underivable_exits_nonzero(
            self, tmp_path, capsys):
        """--derive-femb-table must NOT turn a divergent dump whose
        derivation also failed into exit code 0 (scripts gating on the
        exit code would treat the map as validated)."""
        import json as _json
        from fdreadoutlibs_jax.cli import main as cli_main
        geo = HDAPAChannelMap()
        a = int(geo.offline_channels(0, 2, 3, 64)[10])
        b = int(geo.offline_channels(0, 2, 3, 64)[11])
        p = tmp_path / "dump.txt"
        # a swap inside ONE FEMB diverges from the geometry map AND
        # breaks the per-FEMB uniformity the derivation requires
        TestFidelityHarness._write_dump(
            TestFidelityHarness(), p, geo,
            perturb={(2, 3, 10): b, (2, 3, 11): a})
        rc = cli_main(["validate-map", "-f", str(p),
                       "--derive-femb-table"])
        out = _json.loads(capsys.readouterr().out.strip())
        assert not out["match"] and not out.get("derived_matches")
        assert rc == 1

    def test_frontend_geometry_single_source(self):
        from fdreadoutlibs_jax.utils.channel_map import frontend_geometry
        assert frontend_geometry("wibeth") == (8, 64)
        assert frontend_geometry("wib2") == (2, 256)
        with pytest.raises(ValueError, match="frontend"):
            frontend_geometry("tde")


class TestPackagedDumpDefault:
    """The production default channel map is the checked-in dump file
    (VERDICT r3 #1): data/PD2HD_APA_wibeth.txt is HDAPAChannelMap's default
    femb_table source, and the full-APA mapping is pinned against the file
    value-by-value."""

    def test_default_loads_packaged_dump(self):
        from fdreadoutlibs_jax.utils.channel_map import (
            PACKAGED_DUMP, femb_table_from_dump, packaged_femb_table)
        import os
        assert os.path.exists(PACKAGED_DUMP)
        m = HDAPAChannelMap()
        np.testing.assert_array_equal(m.femb_table, packaged_femb_table())
        np.testing.assert_array_equal(m.femb_table,
                                      femb_table_from_dump(PACKAGED_DUMP))
        # wib2 shares the per-FEMB table (it is frontend-independent data)
        m2 = HDAPAChannelMap(frontend="wib2")
        np.testing.assert_array_equal(m2.femb_table, m.femb_table)

    def test_full_apa_pinned_against_dump(self):
        """Every (crate, slot, stream, chan) -> (offline, plane) of one full
        APA equals the checked-in dump, read back independently through
        TableChannelMap (2560 channels, both frontends' consumers resolve
        through the same femb_table)."""
        from fdreadoutlibs_jax.utils.channel_map import (
            PACKAGED_DUMP, TableChannelMap, cross_check_maps)
        file_map = TableChannelMap.from_file(PACKAGED_DUMP)
        default_map = HDAPAChannelMap()
        keys = [(0, s, st) for s in range(HDAPAChannelMap.N_WIBS)
                for st in range(HDAPAChannelMap.N_STREAMS)]
        rep = cross_check_maps(file_map, default_map, keys)
        assert rep["match"], rep
        assert rep["n_checked"] == HDAPAChannelMap.CHANNELS_PER_APA
        # offline numbers cover the APA exactly once
        all_off = np.concatenate([file_map.offline_channels(0, s, st, 64)
                                  for (_, s, st) in keys])
        assert sorted(all_off.tolist()) == list(range(2560))

    def test_pinned_literal_values(self):
        """Hand-computed spot values (block FEMB layout provenance): first
        U wire, the half-FEMB boundary, and the APA's last collection
        wire — these change only if the packaged dump file changes."""
        m = HDAPAChannelMap()
        get = m.get_offline_channel_from_crate_slot_stream_chan
        assert get(0, 0, 0, 0) == 0                      # femb0 U idx0
        assert m.get_plane_from_offline_channel(0) == 1  # U
        assert get(0, 0, 1, 63) == 1647                  # femb0 X idx47
        assert m.get_plane_from_offline_channel(1647) == 0
        assert get(0, 4, 7, 63) == 2559                  # femb19 X idx47
        assert get(3, 4, 7, 63) == 3 * 2560 + 2559       # crate offset

    def test_dump_provenance_matches_geometry(self):
        """PROVENANCE PIN: the packaged dump is currently generated from
        the geometry derivation (PARITY.md "Channel map provenance").  If
        you replaced data/PD2HD_APA_wibeth.txt with a real detchannelmaps
        dump and this test fails, that is expected — delete this test and
        update PARITY.md; every other consumer follows the file."""
        from fdreadoutlibs_jax.utils.channel_map import (
            PACKAGED_DUMP, TableChannelMap, cross_check_maps)
        geo = HDAPAChannelMap(femb_table="geometry")
        file_map = TableChannelMap.from_file(PACKAGED_DUMP)
        keys = [(0, s, st) for s in range(5) for st in range(8)]
        assert cross_check_maps(file_map, geo, keys)["match"]

    def test_geometry_flag_and_bad_value(self):
        geo = HDAPAChannelMap(femb_table="geometry")
        np.testing.assert_array_equal(geo.femb_table,
                                      HDAPAChannelMap.default_femb_table())
        with pytest.raises(ValueError, match="geometry"):
            HDAPAChannelMap(femb_table="nonsense")

    def test_validate_map_cli_accepts_packaged_dump(self, capsys):
        import json as _json
        from fdreadoutlibs_jax.cli import main as cli_main
        from fdreadoutlibs_jax.utils.channel_map import PACKAGED_DUMP
        rc = cli_main(["validate-map", "-f", PACKAGED_DUMP,
                       "--derive-femb-table"])
        out = _json.loads(capsys.readouterr().out.strip())
        assert rc == 0 and out["match"] and out["derived_matches"]

    def test_write_dump_cli_roundtrip(self, tmp_path, capsys):
        import json as _json
        from fdreadoutlibs_jax.cli import main as cli_main
        from fdreadoutlibs_jax.utils.channel_map import (
            PACKAGED_DUMP, femb_table_from_dump)
        p = tmp_path / "regen.txt"
        rc = cli_main(["channel-map", "--write-dump", str(p)])
        out = _json.loads(capsys.readouterr().out.strip())
        assert rc == 0 and out["rows"] == 2560
        np.testing.assert_array_equal(femb_table_from_dump(str(p)),
                                      femb_table_from_dump(PACKAGED_DUMP))
