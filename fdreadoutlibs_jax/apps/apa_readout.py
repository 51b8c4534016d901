"""Full-APA readout application.

Composes every layer end-to-end, the way a DAQ application (fdreadoutmodules
DataLinkHandler graph) wires the reference:

  emulated WIBEth sources (40 links)
    -> per-link preprocess (sequence/timestamp checks, vectorized)
    -> raw payloads into per-link readout buffers (trigger data requests)
    -> one device ingest over all links: packed bytes -> on-device
       unpack -> hit finding (channels stacked on one axis — the device
       replaces 40 per-link processor threads)
    -> ONE vectorized TP assembly over the whole APA batch (40 per-link
       assembly calls per batch are per-call-overhead-bound on the single
       host core budgeted per APA — scripts/bench_tp_path.py; the
       per-link path stays available as batched_assembly=False)
    -> TP latency buffer (native C++ when available)
    -> TPSet windowing with heartbeats/cutoff + windowed data requests,
       occupancy-bounded cleanup per batch

Batched-assembly observability delta (documented): per-link processors
still carry num_hits/num_tps_sent counters, but the per-channel TP
histogram (top_channels) is tracked once at APA level
(get_info()["apa_top_channels"]) instead of per link, and too-long/
send-failure counters are APA-level.

Run:  python -m fdreadoutlibs_jax.apps.apa_readout --batches 8
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..formats import wibeth
from ..formats.trigprim import TP_DTYPE

from ..ops.chanstate import init_chanstate, seed_chanstate
from ..stream import WIBEthFrameProcessor
from ..stream.transport import QueueSender
from ..tp import TPRequestHandler
from ..tp.latency_buffer import make_latency_buffer

N_LINKS_PER_APA = 40


class APAReadoutApp:
    """40-link APA readout with a single device hot path.

    ``backend`` picks the hit finding: "auto" (ops.backend.hit_backend —
    the GPU kernel on a GPU, ``lax.scan`` on the CPU), "pallas" or
    "scan".  ``pallas_interpret=True`` runs the kernel through the Pallas
    interpreter (CPU tests) and implies "pallas"."""

    def __init__(self, n_links: int = N_LINKS_PER_APA,
                 algorithm: str = "SimpleThreshold", threshold: int = 150,
                 backend: str = "auto", run_number: int = 1,
                 channel_map_name: str = "HDAPAChannelMap",
                 threshold_on_collection: bool = False,
                 time2_feed: bool = False,
                 codec_threads: int = 1,
                 batched_assembly: bool = True,
                 raw_capacity_frames: int = 4096,
                 raw_retention: str = "zerocopy",
                 pipelined: bool = False,
                 pallas_interpret: bool = False,
                 k_slots: int | None = None):
        from ..ops.backend import resolve_backend
        self.backend = "pallas" if pallas_interpret \
            else resolve_backend(backend)
        if self.backend == "reference":
            raise ValueError("the APA app runs 'pallas' or 'scan'")
        self.n_links = n_links
        self.run_number = run_number
        self.tp_q = QueueSender(capacity=1 << 16)
        # one processor instance per link for header validation + metrics;
        # the device hot path is shared (stacked channels) below.
        # Link l = (WIB slot l//8, stream l%8): the HD APA geometry
        # (utils/channel_map.HDAPAChannelMap), so TPs carry real offline
        # channel numbers and threshold-on-collection zeroes the memory
        # factor on collection-plane channels (WIBEthFrameProcessor.cpp:
        # 441-450).
        self.procs = []
        for link in range(n_links):
            p = WIBEthFrameProcessor(tp_sink=self.tp_q)
            p.conf({"source_id": link, "crate_id": 1, "slot_id": link // 8,
                    "link_id": link % 8, "enable_tpg": True,
                    "tpg_algorithm": algorithm, "tpg_threshold": threshold,
                    "tp_timeout": 100_000,
                    "channel_map_name": channel_map_name,
                    "enable_simple_threshold_on_collection":
                        threshold_on_collection})
            p.start()
            self.procs.append(p)
        self.cfg = self.procs[0].tpg_cfg
        self.pallas_interpret = bool(pallas_interpret)
        # emission capacity: hits per channel per tc-tick chunk.  None ->
        # 4, the streaming default (stream/wibeth.py): the constraint is
        # per-channel BURST capacity, not the APA-average rate — two real
        # hits on one wire inside a tc=256 chunk (131 us; overlapping
        # tracks, showers, glitching channels) would silently lose the
        # second at k=1.  Overflow is never silent — it lands in the
        # compact trailer's dropped count.
        self.k_slots = 4 if k_slots is None else k_slots

        self.tpset_q = QueueSender(capacity=1 << 16)
        self.handler = TPRequestHandler(
            tpset_sink=self.tpset_q,
            latency_buffer=make_latency_buffer(TP_DTYPE))
        self.handler.conf({"tpset_transmission_rate_hz": 1000,
                           "tpset_min_latency_ticks": 10 * 2048,
                           "tardy_tp_quiet_time_at_start_sec": 0})
        self.handler.start(run_number=run_number)

        # raw-payload buffers for trigger data requests (one per link)
        from ..formats.adapters import get_adapter
        from ..tp.readout_buffer import ReadoutRequestHandler
        # raw retention per link: capacity frames; cleanup trims to half
        # so inserts never hit the hard cap.  At 32.768 us/frame the
        # default 4096 retains ~67 ms of raw data per link after trim —
        # size to the trigger data-request latency budget (raw stream is
        # 8.8 GB/s/APA: ~4.4 GB of RAM per APA per retained second).
        # Default retention is ZERO-COPY (segment references into the
        # batch slabs process_batch receives — safe because this app
        # never mutates a batch after submission); raw_retention="ring"
        # restores the copying arena for producers that recycle buffers.
        self.raw_capacity_frames = int(raw_capacity_frames)
        self.readout = [ReadoutRequestHandler(get_adapter("wibeth"),
                                              capacity=raw_capacity_frames,
                                              retention=raw_retention)
                        for _ in range(n_links)]

        # time2_feed has the HOST unpack and time-pair the ADCs
        # (native.relayout_time2): the kernel reads half the ADC bytes
        self.time2_feed = time2_feed
        self._stack = None          # kernel state (pallas backend)
        self._scan_state = None     # ChanState dict on device (scan)
        self._dropped_total = 0
        from .. import native
        self._feed_buf = native.FeedBuffer()  # host feed output reuse
        # host codec thread fan-out (native mt)
        self.codec_threads = max(1, int(codec_threads))

        # batched whole-APA TP assembly (module docstring); lookup tables
        # are built lazily after the first batch seeds every processor
        self.batched_assembly = batched_assembly
        from ..utils.metrics import MetricsCollector
        self.metrics = MetricsCollector()        # APA-level (batched path)
        self._offline_table = None
        self._det_table = None
        self._mask_sorted = None
        self._assembly_conf_key = None
        # per-link counters accumulate in vectors and flush to the
        # per-proc MetricsCollectors at get_info (two 40-iteration python
        # inc loops per batch were measurable; observability reads go
        # through get_info, which flushes first)
        self._hits_link = np.zeros(n_links, dtype=np.int64)
        self._sent_link = np.zeros(n_links, dtype=np.int64)
        self._sendfail_link = np.zeros(n_links, dtype=np.int64)
        # shipped-TP retention bound for the data-request path: trimmed
        # oldest-first each batch (the per-link loop never cleaned the
        # handler buffer — unbounded growth over a long run, and python-
        # buffer consolidation cost grows with occupancy)
        self.handler_max_occupancy = 1 << 20

        # per-batch stage latencies (ms), bounded history: the DAQ-side
        # observability the reference gets from its spin-wait handshake
        # accounting (WIBFrameProcessor.hpp:516-518 budgets 6 us per
        # superchunk; here the unit of latency is the batch).  A batch's
        # data-arrival -> TP-available latency = batch span + total_ms;
        # scripts/bench_latency.py turns these into the recommended
        # tpset_min_latency_ticks.  perf_counter pairs cost ~0.1 us/stage.
        from collections import deque
        self.batch_timings = deque(maxlen=4096)
        self._codec_ms = 0.0

        # pipelined (depth-2, double-buffered) batching: process_batch
        # SUBMITS this batch's device work (async XLA dispatch — no sync)
        # and then finishes the PREVIOUS batch (fetch + TP assembly +
        # handler), so host stages, the feed codec, and upstream source
        # work all overlap the in-flight device batch.  Throughput gains
        # max(host, device) per batch instead of host + device; the cost
        # is ~one batch period of extra TP-emission latency (batch N's
        # TPs emit during batch N+1) — batch_timings.total_ms measures
        # the real arrival->TP span either way.  The reference gets the
        # same overlap from its free-running processor threads
        # (wib/WIBFrameProcessor.hpp spin-wait pipeline); here one
        # in-flight batch is the whole story because the device is a
        # single fused stream.  FeedBuffer is double-buffered for exactly
        # this: the previous submit's host feed page is never overwritten
        # while its H2D may still be in flight.
        self.pipelined = bool(pipelined)
        self._pending = None

    # ---- the fused hot path over all links ------------------------------
    def _device_pass(self, frames_links: np.ndarray):
        """frames_links: (L, N, 7200) -> (global hit array over all L*64
        channels, dropped count) (fused device ingest: packed bytes ->
        on-device unpack -> Pallas TPG)."""
        return self._fetch_hits(self._device_submit(frames_links))

    def _fetch_hits(self, packed):
        """The one device->host sync: packed compact-hit array ->
        (canonical hit array, dropped).  Separate seam so host-loop
        benches can stub the device side (scripts/bench_tp_path.py)."""
        from ..ops.ingest import unpack_compact
        return unpack_compact(packed)

    def _device_submit(self, frames_links: np.ndarray):
        """Enqueue one batch's device work and return the (not yet
        fetched) packed compact-hit device array — XLA dispatch is async,
        so this returns immediately while the device works; the carried
        ChanState chains on device between submits.  unpack_compact
        (ONE device->host fetch) turns the result into (hits, dropped)."""
        import jax.numpy as jnp
        from ..ops import ingest
        L, N, _ = frames_links.shape
        T = N * wibeth.N_TIME_SAMPLES
        C = L * wibeth.N_CHANNELS
        max_hits = max(2048, 2 * C)
        words = ingest.host_words(frames_links.reshape(-1, wibeth.FRAME_SIZE)) \
            .reshape(L, T, 28)
        if self._stack is None and self._scan_state is None:
            self._seed(words, C)
        if self.time2_feed:
            # host-side unpack + time-pairing (two ticks per int32 word);
            # pad8=False ships only the ceil(C/128) data rows, the
            # container pad happens on device
            from .. import native
            t_codec = time.perf_counter()
            fed = native.relayout_time2(
                words, out=self._feed_buf.get(
                    native.time2_feed_shape(L, T, pad8=False)),
                nthreads=self.codec_threads, pad8=False)
            self._codec_ms = (time.perf_counter() - t_codec) * 1e3
            dev_in = jnp.asarray(fed)
        else:
            self._codec_ms = 0.0
            dev_in = jnp.asarray(words)
        if self.backend == "scan":
            adcs = ingest.time2_to_adcs(dev_in, C) if self.time2_feed \
                else ingest.words_to_adcs(dev_in)
            packed, self._scan_state = ingest.scan_compact(
                adcs, self._scan_state, self.cfg, max_hits)
            return packed
        from ..ops.pallas_tpg import auto_tc
        from ..utils.tuning import kernel_knobs
        knobs = kernel_knobs(self.cfg, C)
        tc = auto_tc(T, cap=knobs["tc"])
        # interpret mode is a correctness path: no unroll
        u = 1 if self.pallas_interpret else knobs["unroll"]
        ur = u if tc % u == 0 else (8 if tc % 8 == 0 else 1)
        if self.time2_feed:
            fn = ingest.process_time2_feed
            ur = ur if ur % 2 == 0 else 2       # two ticks per word
        else:
            fn = ingest.process_packed_frames
        slots, nclose, self._stack = fn(
            dev_in, self._stack, self.cfg, C, tc=tc,
            k_slots=self.k_slots, unroll=ur,
            interpret=self.pallas_interpret)
        # device-side compaction: only the hit list crosses to the host;
        # overflow beyond max_hits is counted in the trailer's dropped
        # field
        return ingest.compact_on_device(slots, nclose, 0, C, max_hits)

    def _seed(self, words: np.ndarray, C: int) -> None:
        """Seed the carried state from the first tick of the first batch,
        with per-channel memory factors from each link's channel map
        (threshold-on-collection; set by _first_frame_setup, which
        process_batch runs before the device pass)."""
        import jax.numpy as jnp
        first = np.asarray(wibeth.unpack_frames_jnp(
            jnp.asarray(words[:, :1])))[:, 0].reshape(-1)
        rmf = np.concatenate([p.register_memory_factor for p in self.procs])
        state = seed_chanstate(init_chanstate(C), first, rmf)
        if self.backend == "scan":
            from ..ops.scan import state_to_jnp
            self._scan_state = state_to_jnp(state)
        else:
            from ..ops.pallas_tpg import pack_state
            from ..utils.tuning import kernel_knobs
            self._stack = pack_state(
                state, C,
                block_sublanes=kernel_knobs(self.cfg, C)["block_sublanes"])

    def _batched_preprocess(self, frames_links: np.ndarray):
        """All-links sequence/timestamp validation in one vectorized pass
        (the 40 per-link check calls were ~1.5 ms/batch of pure numpy
        small-array overhead — bench_tp_path apa_host_loop).  Clean links
        (the production steady state) only get their carried prev-seq/ts
        updated; a link with any anomaly — or still in first-batch
        seeding, or in emulator mode — falls back to the per-link methods
        so the exact metrics/error-registry/escalation semantics are
        untouched.  Returns (ts_matrix, per-link fallback mask)."""
        L, N, _ = frames_links.shape
        flat = frames_links.reshape(L * N, wibeth.FRAME_SIZE)
        seq = wibeth.get_header_field(flat, "seq_id").astype(
            np.int64).reshape(L, N)
        ts = wibeth.get_timestamp(flat).astype(np.uint64).reshape(L, N)
        fallback = np.zeros(L, dtype=bool)
        prev_seq = np.empty(L, dtype=np.int64)
        prev_ts = np.empty(L, dtype=np.uint64)
        for l, p in enumerate(self.procs):
            prev_seq[l] = p.previous_seq_id
            prev_ts[l] = p.previous_ts
            fallback[l] = (p.emulator_mode or p._first_seq_check
                           or p._first_ts_check)
        exp_seq = (np.concatenate([prev_seq[:, None], seq[:, :-1]],
                                  axis=1) + 1) & 0xFFF
        fallback |= ((seq - exp_seq) & 0xFFF != 0).any(axis=1)
        dts = ts - np.concatenate([prev_ts[:, None], ts[:, :-1]], axis=1)
        fallback |= (dts != wibeth.EXPECTED_TICK_DIFFERENCE).any(axis=1)
        for l in np.flatnonzero(fallback):
            self.procs[l].sequence_check(frames_links[l])
            self.procs[l].timestamp_check(frames_links[l])
            # emulator-mode checks REWRITE header timestamps (fake_*);
            # re-decode so buffer keys/ts0 see what the frames now carry
            ts[l] = wibeth.get_timestamp(frames_links[l]).astype(np.uint64)
        for l, p in enumerate(self.procs):
            if not fallback[l]:
                p.previous_seq_id = int(seq[l, -1])
                p.previous_ts = int(ts[l, -1])
                p.last_processed_daq_ts = int(ts[l, -1])
        return ts, fallback

    def process_batch(self, frames_links: np.ndarray):
        """frames_links: (L, N, 7200) one batch of N frames per link."""
        L, N, _ = frames_links.shape
        if 2 * N > self.raw_capacity_frames:
            # cleanup trims to capacity/2 AFTER insert, so a batch must fit
            # in the remaining half or its newest frames silently drop
            raise ValueError(
                f"raw_capacity_frames={self.raw_capacity_frames} must be "
                f">= 2x frames per batch ({N}) — raise --raw-capacity")
        t0 = time.perf_counter()
        ts_mat, _ = self._batched_preprocess(frames_links)
        ts0 = ts_mat[:, 0].astype(np.int64)
        t1 = time.perf_counter()
        for l in range(L):
            p = self.procs[l]
            frames = frames_links[l]
            if p._first_hit:
                p._first_frame_setup(frames, wibeth.get_adcs(frames[:1])
                                     .reshape(-1, 64)[0].astype(np.int32))
            # raw payloads stay available for trigger data requests
            # (keys precomputed: one header decode already ran above)
            self.readout[l].insert_payloads(frames, keys=ts_mat[l])
            self.readout[l].cleanup(
                max_occupancy=self.raw_capacity_frames // 2)
        t2 = time.perf_counter()

        # submit this batch's device work (async dispatch — the sync
        # point is the compact-hit fetch in _finish_batch)
        packed = self._device_submit(frames_links)
        entry = {"packed": packed, "ts0": ts0, "L": L, "N": N,
                 "t0": t0, "t1": t1, "t2": t2,
                 "codec_ms": self._codec_ms}
        if self.pipelined:
            prev, self._pending = self._pending, entry
            return self._finish_batch(prev) if prev is not None else 0
        return self._finish_batch(entry)

    def _finish_batch(self, e: dict) -> int:
        """Fetch a submitted batch's compact hits (the one device->host
        sync) and run the host TP tail: assembly, handler insert /
        heartbeat / TPSet windowing / cleanup.  Returns the batch's
        dropped count; appends its batch_timings row — in pipelined mode
        total_ms spans submit -> finish across the following batch's host
        stages, i.e. the true data-arrival -> TP-available latency."""
        L, N, ts0 = e["L"], e["N"], e["ts0"]
        t_fetch = time.perf_counter()
        hits, dropped = self._fetch_hits(e["packed"])
        t3 = time.perf_counter()
        self._dropped_total += dropped
        link = hits["channel"] >> 6                 # 64 channels per link
        self._hits_link[:L] += np.bincount(link, minlength=L)
        if self.batched_assembly:
            self._assemble_batch(hits, link, ts0, L)
        else:
            for l in range(L):
                in_link = link == l
                h = hits[in_link].copy()
                h["channel"] -= l * 64
                self.procs[l].process_swtpg_hits(h, int(ts0[l]))
        t4 = time.perf_counter()
        # drain TPs into the latency buffer, emit TPSets; the newest frame
        # timestamp anchors the heartbeat clock so zero-TP batches still
        # advance downstream trigger aggregation
        for batch in self.tp_q.drain():
            self.handler.insert_tps(batch)
        self.handler.note_stream_time(
            int(ts0.max()) + (N - 1) * wibeth.EXPECTED_TICK_DIFFERENCE)
        self.handler.send_tp_sets_once()
        self.handler.cleanup(max_occupancy=self.handler_max_occupancy)
        t5 = time.perf_counter()
        # device_ms: unpipelined = submit+fetch wall (host codec excluded:
        # H2D + kernel + D2H); pipelined = only the observed fetch wait —
        # the overlapped remainder is hidden, which is the mode's point
        dev_ms = (t3 - (t_fetch if self.pipelined else e["t2"])) * 1e3
        if not self.pipelined:
            dev_ms -= e["codec_ms"]
        self.batch_timings.append({
            "preprocess_ms": (e["t1"] - e["t0"]) * 1e3,
            "retention_ms": (e["t2"] - e["t1"]) * 1e3,
            "codec_ms": e["codec_ms"],
            "device_ms": dev_ms,
            "assembly_ms": (t4 - t3) * 1e3,
            "handler_ms": (t5 - t4) * 1e3,
            "total_ms": (t5 - e["t0"]) * 1e3,
        })
        return dropped

    def flush(self) -> int:
        """Finish the in-flight batch (pipelined mode); no-op otherwise.
        Call before reading final counters / TP streams — get_info does
        NOT flush so periodic monitoring never stalls the pipeline."""
        if self._pending is None:
            return 0
        prev, self._pending = self._pending, None
        return self._finish_batch(prev)

    def _assemble_batch(self, hits: np.ndarray, link: np.ndarray,
                        ts0: np.ndarray, L: int) -> None:
        """One vectorized TP assembly over the whole APA batch (replaces
        40 per-link process_swtpg_hits calls; stream/wibeth.assemble_tps
        carries the reference semantics).  Bit-equivalent TP multiset to
        the per-link path
        (tests/test_apps.py::test_batched_assembly_matches_per_link)."""
        from ..stream.wibeth import assemble_tps
        # TP-policy conf can change between batches (channel_mask_set,
        # tp_algo, tp_max_width are live per-processor state in per-link
        # mode); fingerprint it so the batched cache never serves stale
        # conf.  O(L + mask sizes) per batch — negligible vs assembly.
        conf_key = tuple((p.tp_algo, p.tp_max_width,
                          frozenset(p.channel_mask_set))
                         for p in self.procs)
        if conf_key != self._assembly_conf_key:
            self._offline_table = None
            self._assembly_conf_key = conf_key
        if self._offline_table is None:
            algos = {p.tp_algo for p in self.procs}
            widths = {p.tp_max_width for p in self.procs}
            if len(algos) > 1 or len(widths) > 1:
                raise ValueError(
                    "batched assembly requires uniform tp_algo/tp_max_width "
                    f"across links (got algos={algos}, widths={widths}); "
                    "use batched_assembly=False for heterogeneous links")
            # per-link register->offline tables concatenated onto the
            # global channel axis; built after first_frame_setup seeded
            # every processor
            self._offline_table = np.concatenate(
                [p.register_channels for p in self.procs])
            self._det_table = np.array([p.det_id for p in self.procs],
                                       dtype=np.int64)
            # masks are PER LINK (offline numbers can repeat across links
            # under non-injective maps), so match on (link, channel) keys
            masked = [(l, c) for l, p in enumerate(self.procs)
                      for c in p.channel_mask_set]
            self._mask_sorted = (np.sort(np.array(
                [(l << 32) | (c & 0xFFFFFFFF) for l, c in masked],
                dtype=np.int64)) if masked else None)
        tps, kept = assemble_tps(hits, ts0[link], self._offline_table,
                                 self._det_table[link],
                                 self.procs[0].tp_algo)
        kept_link = link[kept]
        # policy layer (mirrors WIBEthFrameProcessor._filter_and_send)
        if self._mask_sorted is not None and len(tps):
            keys = (kept_link.astype(np.int64) << 32) \
                | (tps["channel"].astype(np.int64) & 0xFFFFFFFF)
            keep = ~np.isin(keys, self._mask_sorted)
            tps, kept_link = tps[keep], kept_link[keep]
        too_long = tps["time_over_threshold"] > \
            np.uint64(self.procs[0].tp_max_width)
        n_long = int(too_long.sum())
        if n_long:
            self.metrics.inc("num_tps_suppressed_too_long", n_long)
            tps, kept_link = tps[~too_long], kept_link[~too_long]
        self.metrics.add_channel_tps(tps["channel"])
        if len(tps) == 0:
            return
        sent = self.tp_q.try_send(tps)
        if not sent:
            self.metrics.inc("num_tps_send_failed", len(tps))
        vec = self._sent_link if sent else self._sendfail_link
        vec[:L] += np.bincount(kept_link, minlength=L)

    def latency_info(self, frames_per_batch: int | None = None) -> dict:
        """Data-arrival -> TP-available latency summary over the recorded
        batch history (batch_timings).  A hit's TP becomes window-eligible
        at batch end + processing; the oldest sample of a batch therefore
        waits batch_span + total_ms.  With frames_per_batch the summary
        adds the span and the implied minimum safe tpset_min_latency_ticks
        (62.5 MHz DTS ticks, 2x engineering margin on p95) — the floor
        below which a multi-producer handler would tardy-drop in-flight
        TPs (tp/request_handler.insert_tps; the reference budget analogue
        is the 6 us/superchunk spin-wait, WIBFrameProcessor.hpp:516-518)."""
        if not self.batch_timings:
            return {}
        rows = list(self.batch_timings)
        tot = np.array([r["total_ms"] for r in rows])
        out = {"batches": len(rows),
               "proc_ms_p50": round(float(np.percentile(tot, 50)), 3),
               "proc_ms_p95": round(float(np.percentile(tot, 95)), 3),
               "proc_ms_max": round(float(tot.max()), 3),
               "stages_ms_p50": {
                   k: round(float(np.percentile(
                       [r[k] for r in rows], 50)), 3)
                   for k in rows[0] if k != "total_ms"}}
        if frames_per_batch:
            span_ms = frames_per_batch * wibeth.EXPECTED_TICK_DIFFERENCE \
                * 16e-6                      # 16 ns / DTS tick
            lat_p95_ms = span_ms + out["proc_ms_p95"]
            out["batch_span_ms"] = round(span_ms, 3)
            out["latency_ms_p95"] = round(lat_p95_ms, 3)
            out["min_latency_ticks"] = int(np.ceil(
                2.0 * lat_p95_ms * 62_500))  # 2x margin, ticks/ms
        return out

    def request_raw(self, link: int, start_ts: int, end_ts: int):
        """Serve a trigger data request for raw frames on one link."""
        return self.readout[link].request(start_ts, end_ts)

    def record_fragment(self, link: int, start_ts: int, end_ts: int,
                        recorder, trigger_number: int = 0,
                        sequence_number: int = 0):
        """Serve a data request as a Fragment and persist it (the dataflow
        tier's job upstream of the reference; tp/recorder.py)."""
        frag = self.readout[link].request_fragment(
            start_ts, end_ts, run_number=self.run_number,
            trigger_number=trigger_number, source_id=link,
            sequence_number=sequence_number)
        recorder.write(frag)
        return frag

    def _flush_link_counters(self) -> None:
        for vec, name in ((self._hits_link, "num_hits"),
                          (self._sent_link, "num_tps_sent"),
                          (self._sendfail_link, "num_tps_send_failed")):
            for l in np.flatnonzero(vec):
                self.procs[l].metrics.inc(name, int(vec[l]))
            vec[:] = 0

    def get_info(self) -> dict:
        self._flush_link_counters()
        info = {"handler": self.handler.get_info(),
                "tpsets_queued": len(self.tpset_q),
                "raw_buffered": sum(r.occupancy() for r in self.readout)}
        info["total_tps_sent"] = sum(p.metrics.count("num_tps_sent")
                                     for p in self.procs)
        info["total_hits"] = sum(p.metrics.count("num_hits")
                                 for p in self.procs)
        info["ts_errors"] = sum(p.metrics.count("num_ts_errors")
                                for p in self.procs)
        # per-channel closes beyond the K-slot capacity (K hits per
        # channel per time chunk).  With EMULATED noise near the default
        # threshold this counts 1-tick noise-hit chatter — expected for
        # the demo; at production thresholds (~5 sigma) physical TP rates
        # sit orders of magnitude below the capacity (pallas_tpg docs).
        info["hits_dropped"] = self._dropped_total
        if self.batched_assembly:
            info["apa_top_channels"] = self.metrics.top_channels()
            info["tps_suppressed_too_long"] = self.metrics.count(
                "num_tps_suppressed_too_long")
        return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--links", type=int, default=N_LINKS_PER_APA)
    ap.add_argument("--frames-per-batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--algorithm", default="SimpleThreshold")
    ap.add_argument("--threshold", type=int, default=150)
    ap.add_argument("--signal-rate", type=float, default=0.02,
                    help="signals per channel per batch")
    ap.add_argument("--channel-map", default="HDAPAChannelMap")
    ap.add_argument("--threshold-on-collection", action="store_true",
                    help="production config: memoryless RS on collection-"
                         "plane channels")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "pallas", "scan"],
                    help="hit finding: auto = GPU kernel on a GPU, "
                         "lax.scan on the CPU")
    ap.add_argument("--codec-threads", type=int, default=1,
                    help="host feed codec std::thread fan-out")
    ap.add_argument("--time2-feed", action="store_true",
                    help="host-side unpack + time-pairing "
                         "(native.relayout_time2): the kernel reads half "
                         "the ADC bytes")
    ap.add_argument("--raw-capacity", type=int, default=4096,
                    help="raw frames retained per link for data requests "
                         "(32.768 us each; RAM = 2x this x 7200 B/link)")
    ap.add_argument("--raw-retention", default="zerocopy",
                    choices=["zerocopy", "ring"],
                    help="raw retention: zerocopy segment references "
                         "(default; insert is O(1), no memcpy) or the "
                         "copying ring arena")
    ap.add_argument("--pipelined", action="store_true",
                    help="depth-2 batch pipelining: submit batch N+1's "
                         "device work before finishing batch N — host "
                         "stages and source generation overlap the "
                         "in-flight device batch (throughput up, ~one "
                         "batch period of extra TP latency)")
    ap.add_argument("--per-link-assembly", action="store_true",
                    help="40 per-link TP assembly calls per batch instead "
                         "of the batched whole-APA assembly (A/B + "
                         "reference-shaped observability)")
    args = ap.parse_args(argv)

    from ..utils.runtime import enable_compile_cache
    enable_compile_cache()
    app = APAReadoutApp(n_links=args.links, algorithm=args.algorithm,
                        threshold=args.threshold, backend=args.backend,
                        channel_map_name=args.channel_map,
                        threshold_on_collection=args.threshold_on_collection,
                        time2_feed=args.time2_feed,
                        codec_threads=args.codec_threads,
                        batched_assembly=not args.per_link_assembly,
                        raw_capacity_frames=args.raw_capacity,
                        raw_retention=args.raw_retention,
                        pipelined=args.pipelined)
    rng = np.random.default_rng(0)
    ts = 0x1000000
    t_wall = time.perf_counter()
    data_seconds = 0.0
    for b in range(args.batches):
        L, N = args.links, args.frames_per_batch
        frames = np.zeros((L, N, wibeth.FRAME_SIZE), dtype=np.uint8)
        T = N * 64
        adcs = (900 + rng.normal(0, 30, size=(L, N, 64, 64))).astype(np.uint16)
        n_sig = rng.poisson(args.signal_rate * L * 64)
        for _ in range(n_sig):
            l, c = rng.integers(0, L), rng.integers(0, 64)
            f, t = rng.integers(0, N), rng.integers(0, 50)
            adcs[l, f, t:t + 8, c] += np.uint16(rng.integers(300, 3000))
        for l in range(L):
            wibeth.set_adcs(frames[l], adcs[l])
            wibeth.fake_timestamps(frames[l], ts)
            wibeth.fake_seq_ids(frames[l], b * N)
            wibeth.fake_geoid(frames[l], 1, l // 8, l % 8)
        app.process_batch(frames)
        ts += N * 2048
        data_seconds += T * 32 / 62.5e6
    app.flush()                        # drain the in-flight batch, if any
    wall = time.perf_counter() - t_wall
    info = app.get_info()
    info["wall_seconds"] = round(wall, 3)
    info["data_seconds"] = round(data_seconds, 4)
    info["end_to_end_rtf"] = round(data_seconds / wall, 3)
    print(json.dumps(info, default=str))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
