#!/usr/bin/env python
"""Malformed-frame fuzz: adversarial bytes through every frame processor.

The config-space fuzz (scripts/fuzz_sweep.py) draws random *valid* streams;
this sibling draws random *corrupt* ones — truncated payload files, bit
flips in DAQ headers and packed ADC regions, zeroed / all-ones payloads,
duplicated payloads, deterministic seq/ts discontinuities — and pushes them
through the stream processors, mirroring the reference's error paths
(WIBEthFrameProcessor.cpp:299-405 seq/ts checks, WIBFrameProcessor.hpp:399-438
errored-frame forwarding).  Per case it asserts:

1. NO exception escapes the processor (corrupt data must degrade, not
   crash);
2. deterministic seq/ts corruption is *observed*: the per-processor error
   metrics and the FrameErrorRegistry record it;
3. the stream RESUMES: for the TPG formats the whole corrupted stream is
   driven through two independent backends (XLA scan vs numpy reference)
   and the emitted TP streams must stay bit-exact — including every batch
   after the corruption (state carried across the corrupt payloads agrees).

Usage:  python scripts/fuzz_frames.py --n 100 [--start 50000]
Output: one JSON line per failure (none expected) + a summary line.
Record clean sweeps in PARITY.md ("Fuzz validation record").
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# --------------------------------------------------------------- format rigs

class Rig:
    """One processor family: build a valid stream, corrupt it, drive it."""

    name = ""
    frame_size = 0
    header_bytes = 0          # leading per-payload header region to bit-flip
    dual_backend = True       # scan-vs-reference TP parity
    has_seq = False           # format carries a sequence counter
    checks_ts = True          # processor runs a timestamp-continuity check

    def build(self, rng, n_payloads):
        """-> payloads uint8 (n, frame_size-multiple)"""
        raise NotImplementedError

    def ts_assertable(self, chosen, ts_jump_idx):
        """Whether injected ts discontinuities are guaranteed observable
        (override where per-channel bookkeeping weakens the guarantee)."""
        return self.checks_ts

    def make_proc(self, backend):
        """-> (processor, drain() -> list of TP arrays)"""
        raise NotImplementedError

    def set_ts(self, payloads, idx, value):
        raise NotImplementedError

    def set_seq(self, payloads, idx, value):
        raise NotImplementedError


class WIBEthRig(Rig):
    name = "wibeth"
    has_seq = True

    def __init__(self):
        from fdreadoutlibs_jax.formats import wibeth
        self.f = wibeth
        self.frame_size = wibeth.FRAME_SIZE
        self.header_bytes = 8 * wibeth.HEADER_WORDS

    def build(self, rng, n_payloads):
        f = self.f
        frames = f.empty_frames(n_payloads)
        adcs = (900 + rng.normal(0, 30, size=(n_payloads, 64, 64))) \
            .astype(np.uint16)
        # a couple of genuine pulses so the TP path is exercised
        for _ in range(3):
            p, c = rng.integers(n_payloads), rng.integers(64)
            t = rng.integers(50)
            adcs[p, t:t + 8, c] += 2500
        f.set_adcs(frames, adcs)
        f.fake_timestamps(frames, 10_000)
        f.fake_seq_ids(frames, 1)
        f.fake_geoid(frames, 1, 2, 3)
        return frames

    def make_proc(self, backend):
        from fdreadoutlibs_jax.stream import WIBEthFrameProcessor
        from fdreadoutlibs_jax.stream.transport import QueueSender
        sink = QueueSender()
        proc = WIBEthFrameProcessor(tp_sink=sink)
        proc.conf({"crate_id": 1, "slot_id": 2, "link_id": 3,
                   "enable_tpg": True, "tpg_algorithm": "AbsRS",
                   "tpg_threshold": 300, "tp_timeout": 100_000,
                   "tpg_backend": backend,
                   "channel_map_name": "HDAPAChannelMap"})
        proc.start()
        return proc, sink.drain

    def set_ts(self, payloads, idx, value):
        self.f.set_timestamp(payloads[idx:idx + 1], value)

    def set_seq(self, payloads, idx, value):
        self.f.set_header_field(payloads[idx:idx + 1], "seq_id", value)


class WIB2Rig(Rig):
    name = "wib2"

    def __init__(self):
        from fdreadoutlibs_jax.formats import wib2
        self.f = wib2
        self.frame_size = wib2.SUPERCHUNK_SIZE
        self.header_bytes = 4 * wib2.HEADER_WORDS

    def build(self, rng, n_payloads):
        f = self.f
        sc = f.empty_superchunks(n_payloads)
        frames = f.superchunk_frames(sc)
        adcs = (900 + rng.normal(0, 30, size=(n_payloads, 12, 256))) \
            .astype(np.uint16)
        for _ in range(3):
            p, c = rng.integers(n_payloads), rng.integers(256)
            adcs[p, :, c] += 2500
        f.set_adcs(frames.reshape(-1, f.FRAME_SIZE),
                   adcs.reshape(-1, 256))
        f.fake_timestamps(sc, 50_000)
        f.fake_geoid(sc, 0, 0, 0)
        return sc

    def make_proc(self, backend):
        from fdreadoutlibs_jax.stream import WIB2FrameProcessor
        from fdreadoutlibs_jax.stream.transport import QueueSender
        sink = QueueSender()
        proc = WIB2FrameProcessor(tp_sink=sink)
        proc.conf({"crate_id": 0, "slot_id": 0, "link_id": 0,
                   "enable_tpg": True, "tpg_algorithm": "FIR",
                   "tpg_threshold": 300, "tp_timeout": 100_000,
                   "tpg_backend": backend})
        proc.start()
        return proc, sink.drain

    def set_ts(self, payloads, idx, value):
        frames = self.f.superchunk_frames(payloads[idx:idx + 1])
        self.f.set_timestamp(frames.reshape(-1, self.f.FRAME_SIZE), value)


class ProtoWIBRig(Rig):
    name = "protowib"

    def __init__(self):
        from fdreadoutlibs_jax.formats import protowib
        self.f = protowib
        self.frame_size = protowib.SUPERCHUNK_SIZE
        self.header_bytes = protowib.HEADER_BYTES

    def build(self, rng, n_payloads):
        f = self.f
        sc = f.empty_superchunks(n_payloads)
        frames = f.superchunk_frames(sc)
        adcs = (900 + rng.normal(0, 30, size=(n_payloads, 12, 256))) \
            .astype(np.uint16)
        for _ in range(3):
            p, c = rng.integers(n_payloads), rng.integers(256)
            adcs[p, :, c] += 1500
        f.set_adcs(frames, adcs.reshape(n_payloads, 12, 256))
        f.fake_timestamps(sc, 50_000)
        return sc

    def make_proc(self, backend):
        from fdreadoutlibs_jax.stream.protowib import WIBFrameProcessor
        from fdreadoutlibs_jax.tp.wib_tp_handler import WIBTPHandler
        from fdreadoutlibs_jax.stream.transport import QueueSender
        tp_q = QueueSender()
        handler = WIBTPHandler(tp_sink=tp_q, tpset_sink=QueueSender(),
                               tp_timeout=100_000, tpset_window_size=2_000)
        proc = WIBFrameProcessor(tp_handler=handler,
                                 errored_frame_sink=QueueSender())
        proc.conf({"crate_id": 0, "slot_id": 0, "link_id": 0,
                   "enable_tpg": True, "tpg_backend": backend})
        proc.start()
        return proc, tp_q.drain

    def set_ts(self, payloads, idx, value):
        frames = self.f.superchunk_frames(payloads[idx:idx + 1])
        self.f.set_timestamp(frames, value)


class DAPHNEStreamRig(Rig):
    name = "daphne_stream"

    def __init__(self):
        from fdreadoutlibs_jax.formats import daphne
        self.f = daphne
        self.frame_size = daphne.STREAM_SUPERCHUNK_SIZE
        self.header_bytes = 4 * daphne.HEADER_WORDS

    def build(self, rng, n_payloads):
        f = self.f
        sc = f.empty_superchunks(n_payloads, stream=True)
        frames = f.superchunk_frames(sc, stream=True) \
            .reshape(-1, f.STREAM_FRAME_SIZE)
        n_frames = frames.shape[0]
        adcs = (900 + rng.normal(
            0, 30,
            size=(n_frames, f.STREAM_N_SAMPLES, f.STREAM_N_CHANNELS))) \
            .astype(np.uint16)
        for _ in range(2):
            fr, c = rng.integers(n_frames), rng.integers(f.STREAM_N_CHANNELS)
            adcs[fr, 20:40, c] += 1500
        f.stream_set_adcs(frames, adcs)
        f.fake_timestamps(sc, 30_000, stream=True)
        return sc

    def make_proc(self, backend):
        from fdreadoutlibs_jax.stream.daphne import DAPHNEStreamFrameProcessor
        from fdreadoutlibs_jax.stream.transport import QueueSender
        sink = QueueSender()
        proc = DAPHNEStreamFrameProcessor(tp_sink=sink)
        proc.conf({"enable_tpg": True, "tpg_threshold": 300,
                   "tpg_backend": backend})
        proc.start()
        return proc, sink.drain

    def set_ts(self, payloads, idx, value):
        frames = self.f.superchunk_frames(payloads[idx:idx + 1], stream=True)
        self.f.stream_set_timestamp(
            frames.reshape(-1, self.f.STREAM_FRAME_SIZE), value)


class DAPHNERig(Rig):
    """Self-triggered PDS superchunks (12 x 1816 B) -> DAPHNEFrameProcessor
    pulse analysis.  Single numpy TPG path (no scan/reference pair) and no
    timestamp-continuity assertion (the check is informational for the
    self-triggered stream, src/daphne/DAPHNEFrameProcessor.cpp:54-59)."""

    name = "daphne"
    dual_backend = False
    checks_ts = False

    def __init__(self):
        from fdreadoutlibs_jax.formats import daphne
        self.f = daphne
        self.frame_size = daphne.SUPERCHUNK_SIZE
        self.header_bytes = 4 * daphne.HEADER_WORDS

    def build(self, rng, n_payloads):
        f = self.f
        sc = f.empty_superchunks(n_payloads)
        frames = f.superchunk_frames(sc).reshape(-1, f.FRAME_SIZE)
        n_frames = frames.shape[0]
        wfs = (900 + rng.normal(0, 30, size=(n_frames, f.N_SAMPLES))) \
            .astype(np.uint16)
        for _ in range(3):
            fr = rng.integers(n_frames)
            t = rng.integers(f.N_SAMPLES - 60)
            wfs[fr, t:t + 30] += 1500
        f.set_waveform(frames, wfs)
        f.set_header_field(frames, "link_id",
                           np.arange(n_frames, dtype=np.uint32) % 4)
        f.fake_timestamps(sc, 40_000)
        return sc

    def make_proc(self, backend):
        from fdreadoutlibs_jax.stream.daphne import DAPHNEFrameProcessor
        from fdreadoutlibs_jax.stream.transport import QueueSender
        sink = QueueSender()
        proc = DAPHNEFrameProcessor(tp_sink=sink)
        proc.conf({"enable_tpg": True, "tpg_threshold": 300})
        proc.start()
        return proc, sink.drain

    def set_ts(self, payloads, idx, value):
        frames = self.f.superchunk_frames(payloads[idx:idx + 1])
        self.f.set_timestamp(frames.reshape(-1, self.f.FRAME_SIZE), value)


class TDERig(Rig):
    name = "tde"

    def __init__(self):
        from fdreadoutlibs_jax.formats import tde
        self.f = tde
        self.frame_size = tde.FRAME_SIZE
        self.header_bytes = tde.HEADER_BYTES

    def build(self, rng, n_payloads):
        f = self.f
        frames = f.empty_frames(n_payloads)
        samples = (900 + rng.normal(
            0, 30, size=(n_payloads, f.TOT_ADC16_SAMPLES))).astype(np.uint16)
        for _ in range(2):
            p = rng.integers(n_payloads)
            t = rng.integers(f.TOT_ADC16_SAMPLES - 40)
            samples[p, t:t + 20] += 1500
        f.set_adc_samples(frames, samples)
        f.fake_timestamps(frames, 20_000)
        f.set_channel(frames, np.arange(n_payloads) % 4)
        f.fake_geoid(frames, 0, 0, 0)
        return frames

    def make_proc(self, backend):
        from fdreadoutlibs_jax.stream import TDEFrameProcessor
        from fdreadoutlibs_jax.stream.transport import QueueSender
        sink = QueueSender()
        proc = TDEFrameProcessor(tp_sink=sink)
        proc.conf({"crate_id": 0, "slot_id": 0, "link_id": 0,
                   "enable_tpg": True, "tpg_threshold": 300,
                   "tpg_backend": backend})
        proc.start()
        return proc, sink.drain

    def set_ts(self, payloads, idx, value):
        self.f.set_timestamp(payloads[idx:idx + 1], value)

    def ts_assertable(self, chosen, ts_jump_idx):
        """TDE tracks continuity PER CHANNEL (reference TDEFrameProcessor
        semantics): a jump on a channel's first-ever frame just becomes
        its baseline, and corruptions that rewrite the header's channel
        field (zero/ones/bitflip_header/dup) scramble which frame is
        'first' — only assert in the clean single-ts_jump case past the
        first channel cycle (build() assigns channels = arange(n) % 4)."""
        fragile = {"zero_payload", "ones_payload", "bitflip_header",
                   "dup_payload", "reorder"}
        if set(chosen) & fragile:
            return False
        return ts_jump_idx is None or ts_jump_idx >= 4


class SSPRig(Rig):
    name = "ssp"
    dual_backend = False
    checks_ts = False         # SSP has no continuity check (reference parity)

    def __init__(self):
        from fdreadoutlibs_jax.formats import ssp
        self.f = ssp
        self.frame_size = ssp.FRAME_SIZE
        self.header_bytes = ssp.HEADER_SIZE

    def build(self, rng, n_payloads):
        f = self.f
        frames = f.empty_frames(n_payloads)
        f.set_waveform(frames, (900 + rng.normal(
            0, 30, size=(n_payloads, f.PAYLOAD_SIZE // 2))).astype(np.uint16))
        f.set_timestamp(frames, 40_000 + 100 * np.arange(n_payloads))
        return frames

    def make_proc(self, backend):
        from fdreadoutlibs_jax.stream import SSPFrameProcessor
        proc = SSPFrameProcessor()
        proc.conf({})
        proc.start()
        return proc, lambda: []

    def set_ts(self, payloads, idx, value):
        self.f.set_timestamp(payloads[idx:idx + 1], value)


# ------------------------------------------------------------- corruptions

def corrupt(rig, payloads, rng):
    """Apply 1-3 random corruptions in place; return (names, deterministic)
    where deterministic notes whether a guaranteed-observable ts/seq
    discontinuity was injected on a non-first payload."""
    n = len(payloads)
    raw = payloads.reshape(n, -1).view(np.uint8)
    kinds = ["bitflip_header", "bitflip_adc", "zero_payload", "ones_payload",
             "dup_payload", "ts_jump", "reorder"]
    if rig.has_seq:
        kinds.append("seq_jump")
    chosen = list(rng.choice(kinds, size=int(rng.integers(1, 4)),
                             replace=False))
    deterministic_ts = False
    ts_jump_idx = None
    for kind in chosen:
        idx = int(rng.integers(n))
        if kind == "bitflip_header":
            for _ in range(int(rng.integers(1, 17))):
                b = int(rng.integers(rig.header_bytes))
                raw[idx, b] ^= np.uint8(1 << int(rng.integers(8)))
        elif kind == "bitflip_adc":
            lo = rig.header_bytes
            for _ in range(int(rng.integers(1, 65))):
                b = int(rng.integers(lo, raw.shape[1]))
                raw[idx, b] ^= np.uint8(1 << int(rng.integers(8)))
        elif kind == "zero_payload":
            raw[idx] = 0
        elif kind == "ones_payload":
            raw[idx] = 0xFF
        elif kind == "dup_payload":
            if n >= 2:
                j = int(rng.integers(n - 1)) + 1
                raw[j] = raw[j - 1]
                if rig.checks_ts:
                    deterministic_ts = True   # duplicate ts breaks continuity
        elif kind == "reorder":
            # network reordering: swap two adjacent payloads past the
            # first — a backward ts delta the continuity check must see
            if n >= 3:
                j = int(rng.integers(1, n - 1))
                tmp = raw[j].copy()
                raw[j] = raw[j + 1]
                raw[j + 1] = tmp
                if rig.checks_ts:
                    deterministic_ts = True
        elif kind == "ts_jump":
            if idx == 0:
                idx = min(1, n - 1)
            if idx > 0:
                # full uint64 range: headers can carry any 64-bit garbage
                hi = int(rng.integers(0, 2**62)) * 4 + 2
                rig.set_ts(payloads, idx, hi | 1)
                ts_jump_idx = idx
        elif kind == "seq_jump":
            if idx == 0:
                idx = min(1, n - 1)
            if idx > 0:
                rig.set_seq(payloads, idx, int(rng.integers(4096)))
                # a random seq may coincide with the expected one; don't
                # count it as deterministic (no assertion), it still fuzzes
    if ts_jump_idx is not None and rig.checks_ts:
        deterministic_ts = True
    if not rig.ts_assertable(chosen, ts_jump_idx):
        deterministic_ts = False
    return chosen, deterministic_ts


def drive(rig, payloads, bounds, backend):
    proc, drain = rig.make_proc(backend)
    for a, b in zip(bounds[:-1], bounds[1:]):
        proc.process(payloads[a:b].copy())
    tps = drain()
    tps = np.concatenate(tps) if tps else None
    return proc, tps


def truncated_file_case(rng):
    """FileSourceBuffer must drop a partial tail payload and reject
    sub-payload files (readoutlibs FileSourceBuffer semantics)."""
    from fdreadoutlibs_jax.stream.emulator import FileSourceBuffer
    size = int(rng.integers(64, 8192))
    n_whole = int(rng.integers(0, 4))
    tail = int(rng.integers(1, size))
    data = rng.integers(0, 256, size=n_whole * size + tail, dtype=np.uint8)
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as tf:
        data.tofile(tf)
        path = tf.name
    try:
        buf = FileSourceBuffer(size)
        if n_whole == 0:
            try:
                buf.read(path)
                return "no-complete-payload file must raise"
            except ValueError:
                return None
        got = buf.read(path)
        if got.shape != (n_whole, size):
            return f"truncated read shape {got.shape} != ({n_whole},{size})"
        if not np.array_equal(got.reshape(-1), data[:n_whole * size]):
            return "truncated read bytes differ"
        return None
    finally:
        os.unlink(path)


def run_case(rigs, seed):
    rng = np.random.default_rng(seed)
    if rng.random() < 0.1:
        err = truncated_file_case(rng)
        return {"seed": seed, "rig": "file_truncation", "error": err} \
            if err else None

    rig = rigs[int(rng.integers(len(rigs)))]
    n = int(rng.integers(4, 9))
    payloads = rig.build(rng, n)
    kinds, deterministic_ts = corrupt(rig, payloads, rng)
    # random batch split (state must carry across corrupt boundaries)
    cuts = sorted(rng.choice(np.arange(1, n), size=min(2, n - 1),
                             replace=False).tolist())
    bounds = [0] + cuts + [n]
    case = {"seed": seed, "rig": rig.name, "corruptions": kinds}
    try:
        proc, tps = drive(rig, payloads, bounds, "scan"
                          if rig.dual_backend else "reference")
        if deterministic_ts:
            observed = (proc.metrics.count("num_ts_errors") > 0
                        or proc.error_registry.error_count() > 0)
            if not observed:
                case["error"] = "deterministic ts corruption not observed"
                return case
        if rig.dual_backend:
            _, tps_ref = drive(rig, payloads, bounds, "reference")
            a = tps if tps is not None else np.zeros(0)
            b = tps_ref if tps_ref is not None else np.zeros(0)
            if len(a) != len(b):
                case["error"] = f"TP count scan={len(a)} ref={len(b)}"
                return case
            if len(a) and not np.array_equal(a, b):
                case["error"] = "TP streams diverge between backends"
                return case
    except Exception:
        case["error"] = traceback.format_exc(limit=8)
        return case
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--start", type=int, default=50_000)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")

    rigs = [WIBEthRig(), WIB2Rig(), ProtoWIBRig(), DAPHNEStreamRig(),
            DAPHNERig(), TDERig(), SSPRig()]
    t0 = time.time()
    failures = 0
    by_rig: dict = {}
    for i in range(args.n):
        if i and i % 50 == 0:
            jax.clear_caches()
        res = run_case(rigs, args.start + i)
        if res is not None:
            failures += 1
            print(json.dumps(res), flush=True)
        # track coverage
        rng = np.random.default_rng(args.start + i)
        name = "file_truncation" if rng.random() < 0.1 else \
            rigs[int(rng.integers(len(rigs)))].name
        by_rig[name] = by_rig.get(name, 0) + 1
    print(json.dumps({"cases": args.n, "start": args.start,
                      "failures": failures, "by_rig": by_rig,
                      "elapsed_s": round(time.time() - t0, 1)}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
