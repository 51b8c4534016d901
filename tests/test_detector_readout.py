"""Full-detector composition app: TPC + PDS + TDE arms, shared
request/fragment layer (apps/detector_readout.py)."""

import numpy as np
import pytest

from fdreadoutlibs_jax.formats import daphne, tde, wibeth


def _tpc_batch(b, n_links=2, n_frames=1, pulse_link=None, ts=0x100000):
    frames = np.zeros((n_links, n_frames, wibeth.FRAME_SIZE), np.uint8)
    adcs = np.full((n_links, n_frames, 64, 64), 800, np.uint16)
    if pulse_link is not None:
        adcs[pulse_link, 0, 10:18, 5] += np.uint16(700)
    for l in range(n_links):
        wibeth.set_adcs(frames[l], adcs[l])
        wibeth.fake_timestamps(frames[l], ts)
        wibeth.fake_seq_ids(frames[l], b * n_frames)
        wibeth.fake_geoid(frames[l], 1, l // 8, l % 8)
    return frames


def _pds_batch(n_links=1, n_sc=2, pulse=False, ts=0x200000):
    scs = np.stack([daphne.empty_superchunks(n_sc, stream=True)
                    for _ in range(n_links)])
    frames = daphne.superchunk_frames(scs, stream=True)
    T = n_sc * daphne.STREAM_FRAMES_PER_SUPERCHUNK * daphne.STREAM_N_SAMPLES
    adcs = np.full((n_links, T, 4), 700, np.uint16)
    if pulse:
        adcs[0, 40:60, 2] += np.uint16(900)
    for l in range(n_links):
        daphne.stream_set_adcs(
            frames[l].reshape(-1, daphne.STREAM_FRAME_SIZE),
            adcs[l].reshape(-1, daphne.STREAM_N_SAMPLES, 4))
        daphne.fake_timestamps(scs[l], ts, offset=64, stream=True)
    return scs, T


def _tde_batch(pulse=False, ts=0x300000):
    C, S = tde.N_CHANNELS_PER_LINK, tde.TOT_ADC16_SAMPLES
    frames = tde.empty_frames(C)[None]
    tde.set_channel(frames[0], np.arange(C))
    tde.set_timestamp(frames[0], np.full(C, ts, dtype=np.uint64))
    samples = np.full((C, S), 8000, np.uint16)
    if pulse:
        samples[9, 500:512] += np.uint16(2500)
    tde.set_adc_samples(frames[0], samples)
    return frames


@pytest.fixture(params=[False, True], ids=["sync", "pipelined"])
def det_app(request, interpret_ingest):
    from fdreadoutlibs_jax.apps.detector_readout import DetectorReadoutApp
    return DetectorReadoutApp(apa_links=2, pds_links=1, tde_links=1,
                              tpc_threshold=499, pds_threshold=120,
                              tde_threshold=600, tde_backend="reference",
                              pipelined=request.param)


def test_three_arms_end_to_end(det_app, tmp_path):
    from fdreadoutlibs_jax.apps.detector_readout import (
        PDS_SOURCE_BASE, TDE_SOURCE_BASE, TPC_SOURCE_BASE)
    ts_tpc, ts_pds, ts_tde = 0x100000, 0x200000, 0x300000
    for b in range(3):
        det_app.process_tpc_batch(
            _tpc_batch(b, pulse_link=1 if b == 1 else None, ts=ts_tpc))
        scs, T = _pds_batch(pulse=(b == 1), ts=ts_pds)
        det_app.process_pds_batch(scs)
        det_app.process_tde_batch(_tde_batch(pulse=(b == 1), ts=ts_tde))
        ts_tpc += 2048
        ts_pds += T
        ts_tde += tde.EXPECTED_TICK_DIFFERENCE

    det_app.flush()          # drain in-flight device batches (pipelined)
    info = det_app.get_info()
    assert info["tpc"]["total_hits"] == 1
    assert info["pds"]["total_hits"] >= 1
    assert info["tde"]["total_hits"] == 1
    assert info["tpc"]["ts_errors"] == 0
    assert info["tde"]["ts_errors"] == 0

    # merged TPSet stream is time-ordered and attributable per arm
    sets = det_app.drain_tpsets()
    assert sets == sorted(sets, key=lambda s: (s.start_time, s.origin,
                                               s.seqno))
    origins = {s.origin for s in sets}
    assert origins <= {TPC_SOURCE_BASE, PDS_SOURCE_BASE, TDE_SOURCE_BASE}

    # the shared request layer routes by global SourceID
    raw = det_app.request_raw(TPC_SOURCE_BASE + 1, 0x100000,
                              0x100000 + 3 * 2048)
    assert len(raw) >= 1
    raw_pds = det_app.request_raw(PDS_SOURCE_BASE, 0x200000,
                                  0x200000 + 2 * T)
    assert len(raw_pds) >= 1
    raw_tde = det_app.request_raw(
        TDE_SOURCE_BASE, 0x300000,
        0x300000 + 3 * tde.EXPECTED_TICK_DIFFERENCE)
    assert len(raw_tde) >= 1

    # one recorder serves fragments from every arm
    from fdreadoutlibs_jax.tp.recorder import FragmentRecorder
    rec = FragmentRecorder(tmp_path, run_number=1)
    for i, (sid, t0) in enumerate(((TPC_SOURCE_BASE + 1, 0x100000),
                                   (PDS_SOURCE_BASE, 0x200000),
                                   (TDE_SOURCE_BASE, 0x300000))):
        frag = det_app.record_fragment(sid, t0, t0 + (1 << 24), rec,
                                       trigger_number=i)
        assert frag.header.source_id == sid
    assert len(rec) == 3


def test_source_routing_errors(det_app):
    with pytest.raises(KeyError):
        det_app.resolve_source(500)          # tpc link out of range
    with pytest.raises(KeyError):
        det_app.resolve_source(1005)         # pds link out of range
    name, _, link = det_app.resolve_source(1000)
    assert (name, link) == ("pds", 0)
    name, _, link = det_app.resolve_source(2000)
    assert (name, link) == ("tde", 0)
    name, _, link = det_app.resolve_source(1)
    assert (name, link) == ("tpc", 1)
