#!/usr/bin/env python
"""SWTPG benchmark on one GPU: sustained APA real-time factors, all four
algorithm families, plus the ingest variants, host stages, latency,
frontends and the assembled app.

Headline metric: real-time factor for a full 2560-channel APA running the
PRODUCTION configuration — AbsRS with threshold-on-collection (per-channel
memory factor 0 on collection channels, the deployed DUNE config;
reference src/wibeth/WIBEthFrameProcessor.cpp:441-450).  value = (data
time span processed) / (device wall time) at the WIBEth sampling rate
(2560 ch x 62.5 MHz / 32 = 5.0 GS/s aggregate).  The JSON line reports
every algorithm family so the headline cannot over-represent the cheapest
kernel, and names the device and the card's power limit.

Timing: N windows chained with carried state inside one jitted
``lax.scan``, timed on the host clock around ``block_until_ready``, after
a compile call; the median over trials is reported with the trials.  No
GPU is an error: this script never measures anything else.
"""

import json
import subprocess
import sys
import time

import numpy as np

# 62.5 MHz clock / 32 clocks per WIBEth sample = 1.953125 MHz per channel.
# The RTF conversion lives at the CALLERS (a bench variant timing e.g. a
# DAPHNE stream converts with its own tick rate).
WIBETH_SAMPLE_HZ = 62.5e6 / 32


def device_info() -> dict:
    """The device every number was taken on; raises without a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"bench.py needs a GPU (default device is "
                           f"{dev.platform})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}


def time_per_window(multi, state0, n_windows: int, trials: int):
    """Seconds per window of ``multi`` (N chained windows in one jit), one
    host-clock reading per call around block_until_ready.  Returns
    (median, sorted per-trial values)."""
    import jax
    jax.block_until_ready(multi(state0))              # compile
    per_call = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(multi(state0))
        per_call.append((time.perf_counter() - t0) / n_windows)
    return float(np.median(per_call)), sorted(per_call)


def scan_windows(step, n_windows: int):
    """jit(lax.scan) of ``step(state) -> (slots, nclose, state)`` over
    n_windows with carried state."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def multi(s):
        def body(s, _):
            _, nclose, s = step(s)
            return s, jnp.sum(nclose)
        return jax.lax.scan(body, s, None, length=n_windows)
    return multi


def bench_algorithm(cfg, tc, k_slots, unroll, adcs, rmf, n_windows,
                    trials=5):
    """-> (median RTF, per-trial RTFs, most conservative first)."""
    import jax.numpy as jnp
    from fdreadoutlibs_jax.ops.chanstate import init_chanstate, seed_chanstate
    from fdreadoutlibs_jax.ops.pallas_tpg import (
        decode_pallas_hits, pack_adcs, pack_state, process_window_pallas)
    from fdreadoutlibs_jax.utils.tuning import kernel_knobs

    T, C = adcs.shape
    packed = jnp.asarray(pack_adcs(adcs))
    state0 = pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf), C,
                        block_sublanes=kernel_knobs(cfg, C)["block_sublanes"])

    def one_window(s):
        return process_window_pallas(packed, s, cfg, tc=tc, k_slots=k_slots,
                                     unroll=unroll)

    # sanity-check the hit path before timing it
    slots, nclose, _ = one_window(state0)
    hits, _ = decode_pallas_hits(slots, nclose, C)
    assert len(hits) > 50, \
        f"{cfg.algorithm}: hit path produced only {len(hits)} hits"
    dt, per_call = time_per_window(scan_windows(one_window, n_windows),
                                   state0, n_windows, trials)
    span = T / WIBETH_SAMPLE_HZ
    return span / dt, sorted(span / s for s in per_call)


def bench_fresh_and_ingest(cfg, tc, k_slots, unroll, adcs, rmf,
                           n_windows, trials=5, n_distinct=4):
    """Production-config variants the headline never pays: (a) fresh
    data — every window reads a DISTINCT resident ADC window; (b) ingest
    inclusive — packed 14-bit frame words -> on-device unpack -> kernel;
    (c) the time-paired host feed (the kernel reads half the ADC bytes).
    """
    import jax
    import jax.numpy as jnp
    from fdreadoutlibs_jax.formats import wibeth
    from fdreadoutlibs_jax.ops.chanstate import init_chanstate, seed_chanstate
    from fdreadoutlibs_jax.ops.ingest import (process_packed_frames,
                                              process_time2_feed)
    from fdreadoutlibs_jax.ops.pallas_tpg import (pack_adcs, pack_state,
                                                  pack_time2_jnp,
                                                  process_window_pallas)
    from fdreadoutlibs_jax.utils.tuning import kernel_knobs

    T, C = adcs.shape
    L = C // wibeth.N_CHANNELS
    n_frames = T // wibeth.N_TIME_SAMPLES
    rng = np.random.default_rng(42)
    variants = [adcs] + [np.roll(adcs, rng.integers(1, T), axis=0)
                         for _ in range(n_distinct - 1)]
    windows = [jnp.asarray(pack_adcs(v)) for v in variants]

    def to_words(v):
        frames = wibeth.empty_frames(L * n_frames)
        a = v.reshape(n_frames, wibeth.N_TIME_SAMPLES, L,
                      wibeth.N_CHANNELS).transpose(2, 0, 1, 3)
        wibeth.set_adcs(frames, a.reshape(L * n_frames,
                                          wibeth.N_TIME_SAMPLES,
                                          wibeth.N_CHANNELS)
                        .astype(np.uint16))
        w = wibeth.frames_bytes_to_u32(frames)
        return w.reshape(L, T, wibeth.ADC_WORDS_PER_TS * 2)
    words = [jnp.asarray(to_words(v)) for v in variants]
    t2feeds = [pack_time2_jnp(w) for w in windows]
    state0 = pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf), C,
                        block_sublanes=kernel_knobs(cfg, C)["block_sublanes"])

    # the rotating buffers are jit ARGUMENTS (not closure constants), and
    # window selection is a lax.switch over per-window branches (a dynamic
    # slice would copy a full window per iteration — harness cost, not
    # the ingest cost being measured)
    def rotate_multi(step):
        @jax.jit
        def fn(s, *bufs):
            def body(carry, _):
                s, i = carry
                branches = [(lambda s, w=w: step(w, s)) for w in bufs]
                _, nclose, s = jax.lax.switch(i % n_distinct, branches, s)
                return (s, i + 1), jnp.sum(nclose)
            (s, _), counts = jax.lax.scan(body, (s, 0), None,
                                          length=n_windows)
            return s, counts
        return fn

    u2 = unroll if unroll % 2 == 0 else 2
    arms = [
        ("fresh_data", rotate_multi(lambda w, s: process_window_pallas(
            w, s, cfg, tc=tc, k_slots=k_slots, unroll=unroll)), windows),
        ("ingest_inclusive", rotate_multi(lambda w, s: process_packed_frames(
            w, s, cfg, C, tc=tc, k_slots=k_slots, unroll=unroll)), words),
        ("ingest_time2_feed", rotate_multi(lambda w, s: process_time2_feed(
            w, s, cfg, C, tc=tc, k_slots=k_slots, unroll=u2)), t2feeds),
    ]
    out = {}
    for name, fn, data in arms:
        dt, _ = time_per_window(lambda s, _fn=fn, _d=data: _fn(s, *_d),
                                state0, n_windows, trials)
        out[name] = round((T / WIBETH_SAMPLE_HZ) / dt, 2)
    return out


def bench_host_codecs(seconds: float = 2.0):
    """Steady-state host feed codec throughput (CPU).  Reused aligned
    output buffers, one core (scripts/bench_host_codec.py is the full
    harness)."""
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    import bench_host_codec as codec_bench

    from fdreadoutlibs_jax import native
    if not native.available():
        raise RuntimeError("the native host codec did not build")
    L, T = 40, 4096
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2 ** 32, size=(L, T, 28), dtype=np.uint32)
    gb = words.nbytes / 1e9
    w2_words = rng.integers(0, 2 ** 32, size=(10, T, 112), dtype=np.uint32)
    w2_gb = w2_words.nbytes / 1e9
    out = {}
    for name, nbytes, fn in [
            ("time2", gb, lambda b: native.relayout_time2(
                words, out=b.get(native.time2_feed_shape(L, T)))),
            ("time2_wib2", w2_gb, lambda b: native.relayout_time2(
                w2_words, ch_per_link=256,
                out=b.get(native.time2_feed_shape(10, T,
                                                  ch_per_link=256))))]:
        buf = native.FeedBuffer()
        dt = codec_bench.bench_one(lambda: fn(buf), seconds)
        out[f"host_{name}_GBps_per_core"] = round(nbytes / dt, 2)
    return out


def bench_host_tp_path(trials: int = 3):
    """Compact host TP-path (L3/L4) summary (pure numpy, no device work;
    scripts/bench_tp_path.py is the full harness)."""
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    import bench_tp_path as tp

    rng = np.random.default_rng(7)
    asm = tp.bench_tp_assembly(trials, rng)
    rh = tp.bench_request_handler(trials, rng)
    wh = tp.bench_wib_tp_handler(trials, rng)
    loop = tp.bench_apa_host_loop(trials, rng)
    prod = rh.get("native") or rh["python"]
    return {
        "apa_assembly_pct_core": asm["apa_batched"][
            "apa_call_budget_used_pct"],
        "apa_host_loop_pct_core": loop["pct_core_per_apa"],
        "apa_host_loop_memcpy_baseline_GBps":
            loop["memcpy_baseline_GBps"],
        "request_handler_tps_per_s": prod["insert_window_tps_per_s"],
        "request_handler_headroom_vs_256k": prod["headroom_vs_256k"],
        "request_handler_buffer": "native" if "native" in rh else "python",
        "wib_handler_tps_per_s": wh["tps_per_s"],
    }


def main():
    import os
    from fdreadoutlibs_jax.utils.runtime import enable_compile_cache
    device = device_info()
    enable_compile_cache()
    from fdreadoutlibs_jax.ops import TPGConfig
    from fdreadoutlibs_jax.utils.tuning import kernel_knobs

    C, T, N_WINDOWS = 2560, 8192, 16
    rng = np.random.default_rng(0)
    adcs = (900 + rng.normal(0, 30, size=(T, C))).astype(np.int32)
    # sprinkle realistic signals so the hit path is exercised
    for _ in range(200):
        c, t0 = rng.integers(0, C), rng.integers(0, T - 16)
        adcs[t0:t0 + 8, c] += rng.integers(300, 3000)

    def mixed_rmf(cfg):
        # threshold-on-collection: collection channels memoryless
        # (WIBEthFrameProcessor.cpp:441-450); 3 of every 8 channels
        # collection-like stands in for the plane split
        return np.where(np.arange(C) % 8 < 3, 0, cfg.rs_memory_factor_x10)

    def knobs(cfg):
        k = kernel_knobs(cfg, C)
        return k["tc"], k["k_slots"], k["unroll"]

    prod = TPGConfig.from_raw("AbsRS", threshold=150)
    simple = TPGConfig.from_raw("SimpleThreshold", threshold=150)
    std = TPGConfig.from_raw("StandardRS", threshold=150)
    # reference-shaped FIR records: the WIB/WIB2 consumers derive
    # peaks at TP assembly, so the kernel skips peak tracking
    fir = TPGConfig.from_raw("FIR", threshold=5, track_peaks=False)
    runs = {
        "AbsRS_production": (prod, *knobs(prod), mixed_rmf(prod)),
        "SimpleThreshold": (simple, *knobs(simple), None),
        "StandardRS": (std, *knobs(std), None),
        "FIR": (fir, *knobs(fir), None),
    }

    results, spreads = {}, {}
    for name, (cfg, tc, k, unroll, rmf) in runs.items():
        if rmf is None:
            rmf = cfg.rs_memory_factor_x10
        rtf, per_trial = bench_algorithm(cfg, tc, k, unroll, adcs, rmf,
                                         N_WINDOWS)
        results[name] = round(rtf, 2)
        srt = [round(v, 2) for v in per_trial]
        spreads[name] = {"min": srt[0], "trials": srt}

    cfg, tc, k, unroll, rmf = runs["AbsRS_production"]
    extra = bench_fresh_and_ingest(cfg, tc, k, unroll, adcs, rmf, N_WINDOWS)

    rtf = results["AbsRS_production"]
    out = {
        "metric": "apa_realtime_factor_swtpg_production",
        "value": rtf,
        "unit": "x_realtime_2560ch_APA",
        "vs_baseline": rtf,
        "value_min": spreads["AbsRS_production"]["min"],
        "value_trials": spreads["AbsRS_production"]["trials"],
        "algorithms": results,
        "algorithms_spread": spreads,
        "device": device,
        "production_variants": extra,
        "host_codecs": bench_host_codecs(),
        "host_tp_path": bench_host_tp_path(),
    }
    f, g = extra["fresh_data"], extra["ingest_time2_feed"]
    out["unpack_overhead_pct"] = round(100 * (f / g - 1), 1)

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    # end-to-end TP-emission latency (data-arrival -> TP-available) on the
    # production app config; the full per-arm/per-size study is
    # scripts/bench_latency.py
    import bench_latency as bl
    lat = bl.run_arm("time2", 40, 8, 10, 2, "AbsRS", 120, True, 2, 0.02)
    out["latency"] = {k: lat[k] for k in (
        "proc_ms_p50", "proc_ms_p95", "batch_span_ms", "latency_ms_p95",
        "min_latency_ticks") if k in lat}
    # per-frontend RTF at a production aggregation
    # (scripts/bench_frontends.py: arm docs there)
    import bench_frontends as bf
    out["frontends"] = bf.run_all(trials=3)
    # whole-application RTF: the assembled APAReadoutApp, packed bytes ->
    # TPSets, production config (time2 feed + pipelined + zero-copy
    # retention); scripts/bench_app_rtf.py is the full harness
    import bench_app_rtf as ba
    app = ba.run_bench(links=40, frames=128, warm=2, timed=8)
    out["app_rtf"] = {k: app[k] for k in (
        "rtf_pipelined", "rtf_unpipelined", "batch_span_ms",
        "device_transfer_mb_per_batch", "device_compute_ms", "config")
        if k in app}
    piped = app.get("pipelined", {})
    out["app_rtf"]["tpsets_emitted"] = piped.get("tpsets_drained", 0)
    out["app_rtf"]["tps_sent"] = piped.get("total_tps_sent", 0)
    out["app_rtf"]["ts_errors"] = piped.get("ts_errors")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
