"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

from fdreadoutlibs_jax.formats import wibeth
from fdreadoutlibs_jax.ops import TPGConfig
from fdreadoutlibs_jax.ops.reference import run_reference
from fdreadoutlibs_jax.parallel import APAPipeline, make_link_mesh


def make_words(n_links, n_frames, seed=0):
    rng = np.random.default_rng(seed)
    T = n_frames * wibeth.N_TIME_SAMPLES
    words = np.zeros((n_links, T, 28), dtype=np.uint32)
    all_adcs = np.zeros((n_links, T, 64), dtype=np.int32)
    for l in range(n_links):
        frames = wibeth.empty_frames(n_frames)
        adcs = (800 + rng.normal(0, 25, size=(n_frames, 64, 64))).astype(np.uint16)
        adcs[:, 20:26, (3 * l) % 64] += 2000
        wibeth.set_adcs(frames, adcs)
        words[l] = wibeth.frames_bytes_to_u32(frames).reshape(T, 28)
        all_adcs[l] = adcs.reshape(T, 64)
    return words, all_adcs


def test_mesh_has_8_devices():
    mesh = make_link_mesh()
    assert mesh.devices.size == 8


@pytest.mark.parametrize("n_devices", [1, 4, 8])
def test_sharded_matches_oracle(n_devices):
    """The sharded pipeline produces exactly the per-link oracle hits,
    independent of device count."""
    mesh = make_link_mesh(n_devices)
    n_links = 8
    cfg = TPGConfig(threshold=120)
    pipe = APAPipeline(n_links, cfg, mesh=mesh)
    words, all_adcs = make_words(n_links, n_frames=2)
    hits, n_hits, total = pipe.process(words)
    hits = np.asarray(hits)
    n_hits = np.asarray(n_hits)

    for l in range(n_links):
        h_ref, _ = run_reference(all_adcs[l], cfg, window=128)
        assert n_hits[l] == len(h_ref), f"link {l}"
        got = hits[l][: n_hits[l]]
        order = np.lexsort((got[:, 0], got[:, 1]))
        got = got[order]
        np.testing.assert_array_equal(got[:, 0], h_ref["channel"])
        np.testing.assert_array_equal(got[:, 1], h_ref["end_tick"])
        np.testing.assert_array_equal(got[:, 2], h_ref["charge"])
    assert total == int(n_hits.sum())


def test_state_carries_across_sharded_steps():
    mesh = make_link_mesh(4)
    n_links = 4
    cfg = TPGConfig(threshold=120)
    words, all_adcs = make_words(n_links, n_frames=2, seed=5)

    pipe = APAPipeline(n_links, cfg, mesh=mesh)
    _, n1, _ = pipe.process(words)
    _, n2, _ = pipe.process(words)

    # oracle: two consecutive windows with carried state
    for l in range(n_links):
        stream = np.concatenate([all_adcs[l], all_adcs[l]])
        h_ref, _ = run_reference(stream, cfg, window=128)
        first = (h_ref["end_tick"] < 128).sum()
        assert np.asarray(n1)[l] == first
        assert np.asarray(n2)[l] == len(h_ref) - first


@pytest.mark.parametrize("alg", ["AbsRS", "FIR"])
def test_sharded_other_algorithms(alg):
    """RS/FIR state (incl. the FIR ring buffer) shards correctly."""
    from fdreadoutlibs_jax.ops.config import Algorithm
    mesh = make_link_mesh(4)
    cfg = TPGConfig(algorithm=Algorithm(alg) if alg != "FIR"
                    else Algorithm.FIR,
                    threshold=150 if alg != "FIR" else 5)
    pipe = APAPipeline(4, cfg, mesh=mesh)
    words, all_adcs = make_words(4, n_frames=2, seed=11)
    hits, n_hits, total = pipe.process(words)
    n_hits = np.asarray(n_hits)
    for l in range(4):
        h_ref, _ = run_reference(all_adcs[l], cfg, window=128)
        assert n_hits[l] == len(h_ref), f"link {l}"
    assert total == int(n_hits.sum())


def test_sharded_pallas_fir_no_peak_records():
    """The 2-word (no-peak) record layout flows through the multi-chip
    pallas path's device-side compaction (peak fields emit zero)."""
    from fdreadoutlibs_jax.ops.config import Algorithm
    mesh = make_link_mesh(2)
    cfg = TPGConfig(algorithm=Algorithm.FIR, threshold=5,
                    track_peaks=False)
    pipe = APAPipeline(2, cfg, mesh=mesh, backend="pallas", interpret=True)
    words, all_adcs = make_words(2, n_frames=2, seed=13)
    hits, n_hits, total = pipe.process(words)
    hits, n_hits = np.asarray(hits), np.asarray(n_hits)
    for l in range(2):
        h_ref, _ = run_reference(all_adcs[l], cfg, window=128)
        assert n_hits[l] == len(h_ref), f"link {l}"
        got = hits[l][: n_hits[l]]
        np.testing.assert_array_equal(got[:, 1], h_ref["end_tick"])
        np.testing.assert_array_equal(got[:, 2], h_ref["charge"])
        np.testing.assert_array_equal(got[:, 3], h_ref["tover"])
        assert (got[:, 4] == 0).all() and (got[:, 5] == 0).all()
    assert total == int(n_hits.sum())


@pytest.mark.parametrize("n_devices", [1, 4])
def test_sharded_pallas_backend(n_devices):
    """Production backend: the fused Pallas kernel runs per shard inside
    shard_map with device-side slot decoding."""
    mesh = make_link_mesh(n_devices)
    n_links = 4
    cfg = TPGConfig(threshold=120)
    pipe = APAPipeline(n_links, cfg, mesh=mesh, backend="pallas",
                       interpret=True)
    words, all_adcs = make_words(n_links, n_frames=2)
    hits, n_hits, total = pipe.process(words)
    hits = np.asarray(hits)
    n_hits = np.asarray(n_hits)
    for l in range(n_links):
        h_ref, _ = run_reference(all_adcs[l], cfg, window=128)
        assert n_hits[l] == len(h_ref), f"link {l}"
        got = hits[l][: n_hits[l]]
        np.testing.assert_array_equal(got[:, 0], h_ref["channel"])
        np.testing.assert_array_equal(got[:, 1], h_ref["end_tick"])
        np.testing.assert_array_equal(got[:, 2], h_ref["charge"])
        np.testing.assert_array_equal(got[:, 5], h_ref["peak_time"])
    assert total == int(n_hits.sum())


@pytest.mark.parametrize("n_devices", [1, 2])
def test_sharded_pallas_time2_feed(n_devices):
    """time2_feed: each device consumes its host-relayouted time-paired
    shard (native.relayout_time2 per link group) through the time_packed
    kernel datapath; hits and carried state match the oracle."""
    mesh = make_link_mesh(n_devices)
    n_links = 4
    cfg = TPGConfig(threshold=120)
    pipe = APAPipeline(n_links, cfg, mesh=mesh, backend="pallas",
                       interpret=True, time2_feed=True)
    words, all_adcs = make_words(n_links, n_frames=2)
    hits, n_hits, total = pipe.process(words)
    hits, n_hits = np.asarray(hits), np.asarray(n_hits)
    for l in range(n_links):
        h_ref, st_ref = run_reference(all_adcs[l], cfg, window=128)
        assert n_hits[l] == len(h_ref), f"link {l}"
        got = hits[l][: n_hits[l]]
        np.testing.assert_array_equal(got[:, 0], h_ref["channel"])
        np.testing.assert_array_equal(got[:, 1], h_ref["end_tick"])
        np.testing.assert_array_equal(got[:, 2], h_ref["charge"])
        np.testing.assert_array_equal(got[:, 4], h_ref["peak_adc"])
        ped = np.asarray(pipe.state["pedestals"][l])
        np.testing.assert_array_equal(ped, st_ref["pedestals"])
    assert total == int(n_hits.sum())


def test_time2_feed_requires_pallas_backend():
    with pytest.raises(ValueError, match="time2_feed"):
        APAPipeline(2, TPGConfig(threshold=120), mesh=make_link_mesh(2),
                    backend="scan", time2_feed=True)
