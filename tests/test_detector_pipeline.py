"""Detector-scale 2-D ('apa' x 'link') mesh tests on the virtual CPU mesh.

SURVEY.md §2.7 scale-out: a far-detector module is ~150 independent APAs;
DetectorPipeline runs N of them over a 2-D mesh where each APA owns a
contiguous link-axis device group and the monitoring psum stays on the
'link' axis only (per-APA totals, no 'apa'-axis collectives)."""

import numpy as np
import pytest

from fdreadoutlibs_jax.formats import wibeth
from fdreadoutlibs_jax.ops import TPGConfig
from fdreadoutlibs_jax.ops.reference import run_reference
from fdreadoutlibs_jax.parallel import (APAPipeline, DetectorPipeline,
                                        make_apa_link_mesh, make_link_mesh)


def make_apa_words(n_apas, n_links, n_frames, seed=0):
    rng = np.random.default_rng(seed)
    T = n_frames * wibeth.N_TIME_SAMPLES
    words = np.zeros((n_apas, n_links, T, 28), dtype=np.uint32)
    all_adcs = np.zeros((n_apas, n_links, T, 64), dtype=np.int32)
    for a in range(n_apas):
        for l in range(n_links):
            frames = wibeth.empty_frames(n_frames)
            adcs = (800 + rng.normal(0, 25, size=(n_frames, 64, 64))) \
                .astype(np.uint16)
            # distinct pulse channel per (apa, link) so cross-wiring of
            # shards would be caught
            adcs[:, 20:26, (5 * a + 3 * l) % 64] += 2000
            wibeth.set_adcs(frames, adcs)
            words[a, l] = wibeth.frames_bytes_to_u32(frames).reshape(T, 28)
            all_adcs[a, l] = adcs.reshape(T, 64)
    return words, all_adcs


def test_apa_link_mesh_shape():
    mesh = make_apa_link_mesh(2, 4, backend="cpu")
    assert mesh.axis_names == ("apa", "link")
    assert mesh.devices.shape == (2, 4)


def test_detector_matches_oracle_per_apa():
    mesh = make_apa_link_mesh(2, 2, backend="cpu")
    cfg = TPGConfig(threshold=120)
    det = DetectorPipeline(2, 4, cfg, mesh=mesh)
    words, all_adcs = make_apa_words(2, 4, n_frames=2)
    hits, n_hits, totals = det.process(words)
    hits, n_hits = np.asarray(hits), np.asarray(n_hits)
    for a in range(2):
        for l in range(4):
            h_ref, _ = run_reference(all_adcs[a, l], cfg, window=128)
            assert n_hits[a, l] == len(h_ref), (a, l)
            got = hits[a, l][: n_hits[a, l]]
            order = np.lexsort((got[:, 0], got[:, 1]))
            got = got[order]
            np.testing.assert_array_equal(got[:, 0], h_ref["channel"])
            np.testing.assert_array_equal(got[:, 1], h_ref["end_tick"])
            np.testing.assert_array_equal(got[:, 2], h_ref["charge"])
        # the psum rides the 'link' axis only: totals are PER APA
        assert totals[a] == n_hits[a].sum()


def test_detector_matches_independent_apa_pipelines():
    """The 2-D step is bit-identical to N independent 1-D APA pipelines
    (same per-shard body, same compaction)."""
    cfg = TPGConfig(threshold=120)
    words, _ = make_apa_words(2, 4, n_frames=2, seed=3)

    det = DetectorPipeline(2, 4, cfg, mesh=make_apa_link_mesh(2, 2,
                                                              backend="cpu"))
    d_hits, d_n, d_tot = det.process(words)

    for a in range(2):
        pipe = APAPipeline(4, cfg, mesh=make_link_mesh(2, backend="cpu"))
        hits, n_hits, total = pipe.process(words[a])
        np.testing.assert_array_equal(np.asarray(d_n)[a],
                                      np.asarray(n_hits))
        np.testing.assert_array_equal(np.asarray(d_hits)[a],
                                      np.asarray(hits))
        assert d_tot[a] == total


def test_detector_state_carries_across_batches():
    cfg = TPGConfig(threshold=120)
    mesh = make_apa_link_mesh(2, 2, backend="cpu")
    det = DetectorPipeline(2, 2, cfg, mesh=mesh)
    words, all_adcs = make_apa_words(2, 2, n_frames=2, seed=5)
    _, n1, _ = det.process(words)
    _, n2, _ = det.process(words)
    for a in range(2):
        for l in range(2):
            stream = np.concatenate([all_adcs[a, l], all_adcs[a, l]])
            h_ref, _ = run_reference(stream, cfg, window=128)
            first = (h_ref["end_tick"] < 128).sum()
            assert np.asarray(n1)[a, l] == first
            assert np.asarray(n2)[a, l] == len(h_ref) - first


def test_detector_pallas_backend_interpret():
    """The production Pallas body runs unchanged under the 2-D mesh
    (interpret mode on the CPU mesh; compiled parity is the hardware
    check's job)."""
    cfg = TPGConfig(threshold=120)
    mesh = make_apa_link_mesh(2, 1, backend="cpu")
    det = DetectorPipeline(2, 1, cfg, mesh=mesh, backend="pallas",
                           interpret=True)
    words, all_adcs = make_apa_words(2, 1, n_frames=1, seed=7)
    hits, n_hits, totals = det.process(words)
    hits, n_hits = np.asarray(hits), np.asarray(n_hits)
    for a in range(2):
        h_ref, _ = run_reference(all_adcs[a, 0], cfg, window=64)
        assert n_hits[a, 0] == len(h_ref) == totals[a], a
        got = hits[a, 0][: n_hits[a, 0]]
        order = np.lexsort((got[:, 0], got[:, 1]))
        np.testing.assert_array_equal(got[order][:, 0], h_ref["channel"])
    # the time2 host-feed ingest (per-device relayout -> time_packed
    # datapath) produces the same hits under the 2-D mesh
    det_t2 = DetectorPipeline(2, 1, cfg, mesh=mesh, backend="pallas",
                              interpret=True, time2_feed=True)
    _, n_t2, tot_t2 = det_t2.process(words)
    np.testing.assert_array_equal(np.asarray(n_t2), n_hits)
    np.testing.assert_array_equal(np.asarray(tot_t2), np.asarray(totals))
    # the host codec thread fan-out (native relayout nthreads=) must not
    # change the feed bytes
    det_mt = DetectorPipeline(2, 1, cfg, mesh=mesh, backend="pallas",
                              interpret=True, time2_feed=True,
                              codec_threads=2)
    _, n_mt, tot_mt = det_mt.process(words)
    np.testing.assert_array_equal(np.asarray(n_mt), n_hits)
    np.testing.assert_array_equal(np.asarray(tot_mt), np.asarray(totals))


def test_detector_mesh_validation():
    cfg = TPGConfig(threshold=120)
    mesh = make_apa_link_mesh(2, 2, backend="cpu")
    with pytest.raises(ValueError, match="apa"):
        DetectorPipeline(4, 4, cfg, mesh=mesh)     # apa axis != n_apas
    with pytest.raises(ValueError, match="divide"):
        DetectorPipeline(2, 3, cfg, mesh=mesh)     # 3 links over 2 shards
