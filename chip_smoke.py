#!/usr/bin/env python3
"""On-card smoke test of the readout path on one NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # only the four-card paths

Phases (any failure exits non-zero; the last stdout line is a JSON object
only when every phase passed):

1. device: JAX's default device is a GPU; the card's name and power limit
   (nvidia-smi) and the native host codec are reported.
2. kernel parity at APA width: 2560 channels, three chained windows of
   8192 ticks, the four algorithm families, plain and time-paired input —
   the compiled Triton kernel against the lax.scan path, exact equality of
   hits, drop counts and carried state.
3. kernel vs scan timing at the phase-2 shape (ns per tick, real-time
   factor per APA; one tick is 512 ns).
4. APAReadoutApp end to end: 40 links, AbsRS with threshold-on-collection,
   default and time2 feed, each plain and pipelined, 8 batches of 32
   frames, against a scan-backend run of the same frames.
5. other frontends: WIB2 (10 links), ProtoWIB (dual-plane FIR), the
   DAPHNE stream, the PDS app, DetectorReadoutApp and MultiAPAScheduler
   (2 APAs), each against its scan backend.

--four-cards runs APAPipeline over a 4-card 'link' mesh and
DetectorPipeline over 2 APAs x 2 cards, each against the same work on one
card, bit-exact.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

TICK_NS = 512.0                        # one TPC tick: 32 DTS ticks of 16 ns
APA_LINKS = 40
K_SLOTS = 4                            # the streaming processors' default


# ---- comparators (also used by the CPU tests) ---------------------------------

def check_equal(what: str, got, want) -> None:
    """Exact equality of two arrays (structured hit arrays included)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: shape/dtype {got.shape} {got.dtype} "
                             f"!= {want.shape} {want.dtype}")
    if not np.array_equal(got, want):
        bad = np.flatnonzero(got.reshape(-1) != want.reshape(-1))
        raise AssertionError(f"{what}: {len(bad)} elements differ, first at "
                             f"flat index {bad[0]}")


def check_state(what: str, got: dict, want: dict) -> None:
    for k in want:
        if k == "fir_phase":
            continue
        check_equal(f"{what} state[{k}]", got[k], want[k])


def flatten(info: dict, prefix: str = "") -> dict:
    """Nested app info dicts -> {"arm.key": value}."""
    out = {}
    for k, v in info.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {"platform": platform,
                                              "kind": kind, "count": count}})


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


def log(msg: str) -> None:
    print(msg, flush=True)


def best_time(fn, reps: int) -> float:
    import jax
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return min(times)


# ---- data -----------------------------------------------------------------------

def noise_stream(rng, T: int, C: int, n_pulses: int) -> np.ndarray:
    adcs = (900 + rng.normal(0, 10, size=(T, C))).astype(np.int32)
    for _ in range(n_pulses):
        c, t = rng.integers(0, C), rng.integers(1, T - 12)
        adcs[t:t + rng.integers(1, 10), c] += rng.integers(200, 4000)
    return np.clip(adcs, 0, (1 << 14) - 1)


def collection_factors(cfg, n_links: int) -> np.ndarray:
    """Threshold-on-collection memory factors of an HD APA (link l = WIB
    slot l//8, stream l%8), as APAReadoutApp derives them."""
    from fdreadoutlibs_jax.utils.channel_map import make_map
    cmap = make_map("HDAPAChannelMap")
    planes = np.concatenate([cmap.planes(cmap.offline_channels(
        1, l // 8, l % 8, 64)) for l in range(n_links)])
    return np.where(planes == 0, 0, cfg.rs_memory_factor_x10)


def wibeth_batches(rng, n_batches: int, n_links: int, n_frames: int):
    from fdreadoutlibs_jax.formats import wibeth
    ts = 0x1000000
    out = []
    for b in range(n_batches):
        frames = np.zeros((n_links, n_frames, wibeth.FRAME_SIZE), np.uint8)
        adcs = (900 + rng.normal(0, 10, size=(n_links, n_frames, 64, 64))) \
            .astype(np.uint16)
        for _ in range(rng.poisson(0.05 * n_links * 64)):
            l, c = rng.integers(0, n_links), rng.integers(0, 64)
            f, t = rng.integers(0, n_frames), rng.integers(1, 50)
            adcs[l, f, t:t + 8, c] += np.uint16(rng.integers(300, 3000))
        for l in range(n_links):
            wibeth.set_adcs(frames[l], adcs[l])
            wibeth.fake_timestamps(frames[l], ts)
            wibeth.fake_seq_ids(frames[l], b * n_frames)
            wibeth.fake_geoid(frames[l], 1, l // 8, l % 8)
        out.append(frames)
        ts += n_frames * wibeth.EXPECTED_TICK_DIFFERENCE
    return out


# ---- phases -----------------------------------------------------------------------

def phase_device():
    import jax
    from fdreadoutlibs_jax import native
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (default device is "
                         f"{dev.platform})")
    log(f"card: {card_line()}")
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    if not native.available():
        raise SystemExit("chip_smoke: the native host codec did not build")
    return dev


def family_cases(n_links: int):
    from fdreadoutlibs_jax.ops import Algorithm, TPGConfig
    absrs = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=250)
    return [
        ("AbsRS-toc", absrs, collection_factors(absrs, n_links)),
        ("SimpleThreshold",
         TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=150), None),
        ("StandardRS",
         TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=250), None),
        ("FIR", TPGConfig(algorithm=Algorithm.FIR, threshold=5,
                          track_peaks=False), None),
    ]


def phase_kernel(T: int = 8192, C: int = 2560, n_windows: int = 3,
                 reps: int = 5):
    """Phases 2 and 3."""
    import jax.numpy as jnp
    from fdreadoutlibs_jax.ops.chanstate import init_chanstate, seed_chanstate
    from fdreadoutlibs_jax.ops.hits import (apply_slot_capacity, concat_hits,
                                            decode_dense)
    from fdreadoutlibs_jax.ops.pallas_tpg import (decode_pallas_hits,
                                                  pack_adcs, pack_adcs_time2,
                                                  pack_state,
                                                  process_window_pallas,
                                                  unpack_state)
    from fdreadoutlibs_jax.ops.scan import process_window_scan, state_to_jnp
    from fdreadoutlibs_jax.utils.tuning import kernel_knobs
    rng = np.random.default_rng(11)
    adcs = noise_stream(rng, n_windows * T, C,
                        n_pulses=n_windows * T * C // 7000)
    dense = [jnp.asarray(adcs[w * T:(w + 1) * T]) for w in range(n_windows)]
    feeds = {False: [jnp.asarray(pack_adcs(adcs[w * T:(w + 1) * T]))
                     for w in range(n_windows)],
             True: [jnp.asarray(pack_adcs_time2(adcs[w * T:(w + 1) * T]))
                    for w in range(n_windows)]}
    timings = []
    for name, cfg, rmf in family_cases(C // 64):
        st0 = seed_chanstate(init_chanstate(C), adcs[0],
                             cfg.rs_memory_factor_x10 if rmf is None else rmf)
        state = state_to_jnp(st0)
        parts = []
        for w in range(n_windows):
            closed, rec, state = process_window_scan(dense[w], state, cfg)
            parts.append(decode_dense(closed, rec, tick_offset=w * T))
        ref_hits = concat_hits(parts)
        ref_state = {k: np.asarray(v) for k, v in state.items()}
        knobs = kernel_knobs(cfg, C)
        for time2 in (False, True):
            unroll = knobs["unroll"]

            def run(x, stack):
                return process_window_pallas(x, stack, cfg, tc=knobs["tc"],
                                             k_slots=K_SLOTS, unroll=unroll,
                                             time_packed=time2)
            stack = pack_state(st0, C, block_sublanes=knobs["block_sublanes"])
            parts, dropped = [], 0
            for w in range(n_windows):
                slots, nclose, stack = run(feeds[time2][w], stack)
                h, d = decode_pallas_hits(slots, nclose, C,
                                          tick_offset=w * T)
                parts.append(h)
                dropped += d
            what = f"kernel {name} {'time2' if time2 else 'plain'}"
            if len(ref_hits) == 0:
                raise AssertionError(f"{what}: no hits to compare")
            want, want_dropped = apply_slot_capacity(ref_hits, knobs["tc"],
                                                     K_SLOTS)
            check_equal(f"{what} dropped", dropped, want_dropped)
            check_equal(f"{what} hits", concat_hits(parts), want)
            check_state(what, unpack_state(stack, C), ref_state)
            log(f"parity ok: {what}: {len(want)} hits, {dropped} over the "
                f"K-slot capacity, over {n_windows} x {T} ticks x {C} "
                f"channels")
            stack0 = pack_state(st0, C,
                                block_sublanes=knobs["block_sublanes"])
            t_k = best_time(lambda: run(feeds[time2][0], stack0)[2], reps)
            timings.append((name, "time2" if time2 else "plain", t_k))
        t_s = best_time(lambda: process_window_scan(dense[0], state_to_jnp(st0),
                                                    cfg)[0], 3)
        timings.append((name, "scan", t_s))
    for name, path, t in timings:
        ns = t / T * 1e9
        log(f"timing {name} {path}: {t * 1e3:.4f} ms per {T}-tick window "
            f"x {C} ch, {ns:.2f} ns/tick, real-time factor per APA "
            f"{TICK_NS / ns:.3f}")


def run_apa_app(batches, backend: str, time2: bool, pipelined: bool):
    from fdreadoutlibs_jax.apps.apa_readout import APAReadoutApp
    app = APAReadoutApp(n_links=APA_LINKS, algorithm="AbsRS",
                        threshold=250, threshold_on_collection=True,
                        backend=backend, time2_feed=time2,
                        pipelined=pipelined)
    hits = []
    fetch = app._fetch_hits

    def recording_fetch(packed):
        h, d = fetch(packed)
        hits.append(h.copy())
        return h, d
    app._fetch_hits = recording_fetch
    t0 = time.perf_counter()
    for frames in batches:
        app.process_batch(frames.copy())
    app.flush()
    wall = time.perf_counter() - t0
    info = app.get_info()
    info["stages_ms_p50"] = app.latency_info()["stages_ms_p50"]
    return hits, info, wall


def phase_app(n_batches: int = 8, n_frames: int = 32):
    from fdreadoutlibs_jax.formats import wibeth
    from fdreadoutlibs_jax.ops import Algorithm, TPGConfig
    from fdreadoutlibs_jax.ops.hits import apply_slot_capacity, concat_hits
    from fdreadoutlibs_jax.ops.pallas_tpg import auto_tc
    from fdreadoutlibs_jax.utils.tuning import kernel_knobs
    absrs = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=250)
    rng = np.random.default_rng(12)
    batches = wibeth_batches(rng, n_batches, APA_LINKS, n_frames)
    data_s = n_batches * n_frames * wibeth.N_TIME_SAMPLES * TICK_NS * 1e-9
    for time2 in (False, True):
        feed = "time2" if time2 else "default"
        # warm-up runs compile every shape outside the timed runs
        run_apa_app(batches[:2], "scan", time2, False)
        run_apa_app(batches[:2], "pallas", time2, False)
        ref, ref_info, ref_wall = run_apa_app(batches, "scan", time2, False)
        if ref_info["total_hits"] == 0:
            raise AssertionError(f"app {feed}: scan run found no hits")
        log(f"app {feed} scan: {ref_info['total_hits']} hits, wall "
            f"{ref_wall * 1e3:.3f} ms, real-time factor "
            f"{data_s / ref_wall:.4f}, stage p50 ms "
            f"{ref_info['stages_ms_p50']}")
        # the kernel keeps K hits per channel per tc-tick chunk of a batch
        T = n_frames * wibeth.N_TIME_SAMPLES
        tc = auto_tc(T, cap=kernel_knobs(absrs, APA_LINKS * 64)["tc"])
        capped = [apply_slot_capacity(h, tc, K_SLOTS) for h in ref]
        want = concat_hits([h for h, _ in capped])
        want_dropped = sum(d for _, d in capped)
        for pipelined in (False, True):
            what = f"app {feed}{' pipelined' if pipelined else ''}"
            hits, info, wall = run_apa_app(batches, "pallas", time2,
                                           pipelined)
            check_equal(f"{what} hits", concat_hits(hits), want)
            check_equal(f"{what} hits_dropped", info["hits_dropped"],
                        want_dropped)
            check_equal(f"{what} total_hits", info["total_hits"], len(want))
            check_equal(f"{what} ts_errors", info["ts_errors"], 0)
            if not want_dropped:
                check_equal(f"{what} total_tps_sent", info["total_tps_sent"],
                            ref_info["total_tps_sent"])
            if info["ts_errors"] or not info["total_hits"] \
                    or not info["tpsets_queued"]:
                raise AssertionError(f"{what}: {info}")
            log(f"{what} kernel: {info['total_hits']} hits, "
                f"{info['tpsets_queued']} TPSets, wall {wall * 1e3:.3f} ms, "
                f"real-time factor {data_s / wall:.4f}, stage p50 ms "
                f"{info['stages_ms_p50']}")


def phase_frontends():
    from fdreadoutlibs_jax.formats import daphne, protowib, wib2, wibeth
    from fdreadoutlibs_jax.models.algorithms import run_model
    from fdreadoutlibs_jax.ops import Algorithm, TPGConfig
    from fdreadoutlibs_jax.ops.hits import apply_slot_capacity, concat_hits
    from fdreadoutlibs_jax.ops.ingest import StreamingIngest
    from fdreadoutlibs_jax.ops.pallas_tpg import auto_tc
    rng = np.random.default_rng(13)
    absrs = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=250)

    def streaming(fmt, frames_batches, adcs_batches, n_links, cfg):
        ing = StreamingIngest(cfg, n_links=n_links, format=fmt,
                              device_compact=True, max_hits=8192)
        got, dropped, offset, T = [], 0, 0, 0
        for fr in frames_batches:
            out = ing.submit(fr)
            if out is not None:
                got.append(out[0])
                dropped += out[1]
        out = ing.flush()
        got.append(out[0])
        dropped += out[1]
        adcs = np.concatenate(adcs_batches).astype(np.int32)
        want, _ = run_model(adcs, cfg, backend="scan")
        tc = auto_tc(len(adcs_batches[0]), cap=ing.tc)
        want, want_dropped = apply_slot_capacity(want, tc, ing.k_slots)
        check_equal(f"{fmt} dropped", dropped, want_dropped)
        check_equal(f"{fmt} hits", concat_hits(got), want)
        if len(want) == 0:
            raise AssertionError(f"{fmt}: no hits")
        log(f"frontend ok: {fmt} ({n_links} links): {len(want)} hits")

    # WIB2: 10 links, one tick of 256 channels per frame
    L, N = 10, 768
    fr_b, ad_b = [], []
    for _ in range(3):
        adcs = (900 + rng.normal(0, 20, (L, N, 256))).astype(np.uint16)
        for _ in range(200):
            l, c, t = rng.integers(0, L), rng.integers(0, 256), \
                rng.integers(0, N - 10)
            adcs[l, t:t + 8, c] += np.uint16(rng.integers(300, 3000))
        frames = np.stack([wib2.empty_frames(N) for _ in range(L)])
        for l in range(L):
            wib2.set_adcs(frames[l], adcs[l])
        fr_b.append(frames)
        ad_b.append(adcs.transpose(1, 0, 2).reshape(N, L * 256))
    streaming("wib2", fr_b, ad_b, L, absrs)

    # DAPHNE stream: 10 links of 4 channels, 64 ticks per frame
    L, NF = 10, 96
    fr_b, ad_b = [], []
    for _ in range(3):
        adcs = (700 + rng.normal(0, 8, (L, NF * 64, 4))).astype(np.uint16)
        for _ in range(40):
            l, c, t = rng.integers(0, L), rng.integers(0, 4), \
                rng.integers(0, NF * 64 - 20)
            adcs[l, t:t + 12, c] += np.uint16(rng.integers(200, 900))
        frames = np.zeros((L, NF, daphne.STREAM_FRAME_SIZE), np.uint8)
        for l in range(L):
            daphne.stream_set_adcs(frames[l], adcs[l].reshape(NF, 64, 4))
        fr_b.append(frames)
        ad_b.append(adcs.transpose(1, 0, 2).reshape(NF * 64, L * 4))
    streaming("daphne_stream", fr_b, ad_b, L,
              TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=60))

    # ProtoWIB: dual-plane FIR through the processor, kernel vs scan
    from fdreadoutlibs_jax.stream.protowib import WIBFrameProcessor
    from fdreadoutlibs_jax.tp.wib_tp_handler import WIBTPHandler
    from fdreadoutlibs_jax.stream.transport import QueueSender
    n_sc = 64
    adcs = (800 + rng.normal(0, 8, (n_sc * 12, 256))).astype(np.uint16)
    for _ in range(60):
        c, t = rng.integers(0, 256), rng.integers(0, n_sc * 12 - 10)
        adcs[t:t + 8, c] += np.uint16(rng.integers(300, 900))
    sc = protowib.empty_superchunks(n_sc)
    protowib.set_adcs(protowib.superchunk_frames(sc),
                      adcs.reshape(n_sc, 12, 256))
    protowib.fake_timestamps(sc, 50_000)
    seen = {}
    for backend in ("scan", "pallas"):
        proc = WIBFrameProcessor(tp_handler=WIBTPHandler(QueueSender(1 << 16)))
        proc.conf({"enable_tpg": True, "tpg_backend": backend})
        proc.start()
        rec = []
        emit = proc._emit_tps

        def recording_emit(hits, *a, _emit=emit, _rec=rec):
            _rec.append(hits.copy())
            return _emit(hits, *a)
        proc._emit_tps = recording_emit
        for i in range(0, n_sc, 16):
            proc.process(sc[i:i + 16].copy())
        seen[backend] = (rec, proc.metrics.count("num_hits"))
    check_equal("protowib hit count", seen["pallas"][1], seen["scan"][1])
    for i, (a, b) in enumerate(zip(seen["pallas"][0], seen["scan"][0])):
        check_equal(f"protowib hits[{i}]", a, b)
    if not seen["scan"][1]:
        raise AssertionError("protowib: no hits")
    log(f"frontend ok: protowib: {seen['scan'][1]} hits")

    # PDS app and the full detector app, kernel vs scan
    from fdreadoutlibs_jax.apps.detector_readout import main as det_main
    from fdreadoutlibs_jax.apps.pds_readout import main as pds_main
    import contextlib
    import io
    for what, main, argv in (
            ("pds app", pds_main, ["--links", "10", "--batches", "4"]),
            ("detector app", det_main, ["--apa-links", "40", "--batches",
                                        "3"])):
        infos = {}
        for backend in ("scan", "pallas"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(argv + ["--backend", backend])
            infos[backend] = json.loads(buf.getvalue().strip()
                                        .splitlines()[-1])
        s, p = flatten(infos["scan"]), flatten(infos["pallas"])
        # every close the scan path finds is reported or counted as
        # dropped over the kernel's K-slot capacity (TPSet counts follow
        # the wall clock and are not compared)
        arms = [k[:-len("total_hits")] for k in s if k.endswith("total_hits")]
        for arm in arms:
            closes = [d[arm + "total_hits"] + d.get(arm + "hits_dropped", 0)
                      for d in (p, s)]
            check_equal(f"{what} {arm}closes", closes[0], closes[1])
            check_equal(f"{what} {arm}ts_errors", p[arm + "ts_errors"],
                        s[arm + "ts_errors"])
            if not s[arm + "total_hits"]:
                raise AssertionError(f"{what} {arm}: no hits")
        log(f"frontend ok: {what}: " + ", ".join(
            f"{a or 'app.'}hits={p[a + 'total_hits']}+"
            f"{p.get(a + 'hits_dropped', 0)} dropped" for a in arms))

    # MultiAPAScheduler: 2 APAs through one executable vs scan per APA
    from fdreadoutlibs_jax.apps.scheduler import MultiAPAScheduler
    sched = MultiAPAScheduler(absrs, n_apas=2, n_links=APA_LINKS, k_slots=4)
    per_apa = [wibeth_batches(rng, 3, APA_LINKS, 16) for _ in range(2)]
    got = {0: [], 1: []}
    for b in range(3):
        for apa in range(2):
            out = sched.submit(apa, per_apa[apa][b])
            if out is not None:
                got[apa].append(out)
    for apa, out in sched.flush().items():
        got[apa].append(out)
    for apa in range(2):
        adcs = np.concatenate([
            wibeth.get_adcs(f.reshape(-1, wibeth.FRAME_SIZE))
            .reshape(APA_LINKS, -1, 64).transpose(1, 0, 2)
            .reshape(-1, APA_LINKS * 64) for f in per_apa[apa]]) \
            .astype(np.int32)
        want, _ = run_model(adcs, absrs, backend="scan")
        want, want_dropped = apply_slot_capacity(
            want, auto_tc(16 * wibeth.N_TIME_SAMPLES, cap=sched.tc),
            sched.k_slots)
        check_equal(f"scheduler apa{apa} dropped",
                    sum(d for _, d in got[apa]), want_dropped)
        check_equal(f"scheduler apa{apa} hits",
                    concat_hits([h for h, _ in got[apa]]), want)
    log("frontend ok: MultiAPAScheduler (2 APAs)")


def phase_four_cards(n_frames: int = 32, n_windows: int = 3,
                     interpret: bool = False):
    """APAPipeline over a 4-card 'link' mesh and DetectorPipeline over
    2 APAs x 2 cards, each against the same work on one card."""
    from fdreadoutlibs_jax.formats import wibeth
    from fdreadoutlibs_jax.ops import Algorithm, TPGConfig
    from fdreadoutlibs_jax.parallel import (APAPipeline, DetectorPipeline,
                                            make_apa_link_mesh, make_link_mesh)
    cfg = TPGConfig(algorithm=Algorithm.ABS_RS, threshold=250)
    rng = np.random.default_rng(14)
    T = n_frames * wibeth.N_TIME_SAMPLES

    def words_of(frames):
        return wibeth.frames_bytes_to_u32(
            frames.reshape(-1, wibeth.FRAME_SIZE)).reshape(
                frames.shape[0], T, 28)

    apa_words = [[words_of(f) for f in wibeth_batches(
        rng, n_windows, APA_LINKS, n_frames)] for _ in range(2)]

    def run(pipe, windows):
        outs = [pipe.process(w) for w in windows]
        return ([(np.asarray(h), np.asarray(n), t) for h, n, t in outs],
                {k: np.asarray(v) for k, v in pipe.state.items()})

    one = [run(APAPipeline(APA_LINKS, cfg, mesh=make_link_mesh(1),
                           backend="pallas", interpret=interpret), apa_words[a])
           for a in range(2)]
    four, four_state = run(APAPipeline(APA_LINKS, cfg, mesh=make_link_mesh(4),
                                       backend="pallas", interpret=interpret),
                           apa_words[0])
    for w, (a, b) in enumerate(zip(four, one[0][0])):
        for i, name in enumerate(("hits", "n_hits", "total")):
            check_equal(f"4-card APAPipeline window {w} {name}", a[i], b[i])
    check_state("4-card APAPipeline", four_state, one[0][1])
    if not sum(t for _, _, t in four):
        raise AssertionError("4-card APAPipeline: no hits")
    log(f"four cards ok: APAPipeline 40 links over 4 cards, "
        f"{sum(t for _, _, t in four)} hits in {n_windows} windows")

    det = DetectorPipeline(2, APA_LINKS, cfg, mesh=make_apa_link_mesh(2, 2),
                           backend="pallas", interpret=interpret)
    for w in range(n_windows):
        hits, n_hits, totals = det.process(
            np.stack([apa_words[a][w] for a in range(2)]))
        for a in range(2):
            h1, n1, t1 = one[a][0][w]
            check_equal(f"detector apa{a} window {w} hits",
                        np.asarray(hits)[a], h1)
            check_equal(f"detector apa{a} window {w} n_hits",
                        np.asarray(n_hits)[a], n1)
            check_equal(f"detector apa{a} window {w} total", totals[a], t1)
    for k, v in det.state.items():
        for a in range(2):
            check_equal(f"detector apa{a} state[{k}]", np.asarray(v)[a],
                        one[a][1][k])
    log("four cards ok: DetectorPipeline 2 APAs x 2 cards")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths (needs 4 GPUs)")
    args = ap.parse_args(argv)

    import jax
    dev = phase_device()
    from fdreadoutlibs_jax.utils.runtime import enable_compile_cache
    enable_compile_cache()
    t0 = time.perf_counter()
    if args.four_cards:
        if len(jax.devices()) < 4:
            raise SystemExit(f"chip_smoke --four-cards: need 4 GPUs, have "
                             f"{len(jax.devices())}")
        phase_four_cards()
    else:
        phase_kernel()
        phase_app()
        phase_frontends()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(result_line(dev.platform, dev.device_kind, len(jax.devices())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
