"""Full-APA / multi-chip SWTPG pipeline.

The "training step" analogue of this framework: one jitted step consumes a
batch of packed WIBEth ADC words for L links, runs unpack + the SWTPG scan
with carried per-channel state, compacts hits on device, and psums a
monitoring aggregate — all sharded over the 'link' mesh axis via shard_map.

backend="pallas" runs the GPU hit-finding kernel (ops.pallas_tpg) per
shard over that shard's stacked channel axis; backend="scan" is the
portable XLA path.
"""

from __future__ import annotations


from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..formats import wibeth
from ..ops import TPGConfig
from ..ops.chanstate import init_chanstate, seed_chanstate
from ..ops.scan import STATE_KEYS, compact_hits_device, process_window_scan

N_CH = wibeth.N_CHANNELS


def _stack_from_state(st: dict, C: int, block_sublanes: int):
    """jnp equivalent of pallas_tpg.pack_state for one shard: state dict of
    (C,) arrays -> (NB, KSTATE, SUB, 128) int32."""
    from ..ops.chanstate import FIELDS
    from ..ops.pallas_tpg import KSTATE, LANES, N_FIR_TAPS, pad_sublanes
    S = pad_sublanes(C)
    sub = block_sublanes
    rows = [st[k] for k in FIELDS] + [st["rs_memory_factor"]]
    rows += [st["fir_prev"][j] for j in range(N_FIR_TAPS)]
    stack = jnp.stack([jnp.pad(r, (0, S * LANES - C)) for r in rows])
    return stack.reshape(KSTATE, S // sub, sub, LANES).transpose(1, 0, 2, 3)


def _state_from_stack(stack, C: int) -> dict:
    from ..ops.chanstate import FIELDS
    from ..ops.pallas_tpg import KSTATE, N_FIR_TAPS
    flat = stack.transpose(1, 0, 2, 3).reshape(KSTATE, -1)[:, :C]
    st = {k: flat[i] for i, k in enumerate(FIELDS)}
    st["rs_memory_factor"] = flat[len(FIELDS)]
    st["fir_prev"] = flat[len(FIELDS) + 1: len(FIELDS) + 1 + N_FIR_TAPS]
    return st


# device-side per-link K-slot decode lives in ops.hits (shared with the
# single-chip StreamingIngest device_compact path)
from ..ops.hits import compact_slot_words as _compact_link_slots  # noqa: E402


def _make_local(cfg: TPGConfig, max_hits_per_link: int, backend: str,
                k_slots: int, interpret: bool, time2_feed: bool):
    """The per-shard step body shared by make_apa_step (1-D 'link' mesh)
    and make_detector_step (2-D 'apa' x 'link' mesh): unpack + SWTPG scan
    with carried state + device hit compaction, psum-ing the monitoring
    aggregates over the 'link' axis ONLY (so a detector mesh gets per-APA
    totals for free)."""

    def _local_pallas(words, state):
        from ..ops.pallas_tpg import (LANES, auto_tc, pad_sublanes,
                                      process_window_pallas, record_words)
        from ..utils.tuning import kernel_knobs
        Lloc = state["pedestals"].shape[0]
        C = Lloc * N_CH
        st = {k: (state[k].transpose(1, 0, 2).reshape(-1, C)
                  if k == "fir_prev" else state[k].reshape(C))
              for k in STATE_KEYS}
        knobs = kernel_knobs(cfg, C)
        S = pad_sublanes(C)
        if time2_feed:
            # host-side unpack + time-pairing per device group: the kernel
            # reads half the ADC bytes; feed shard is (1, T/2, S, 128)
            kernel_in = words[0]
            T = 2 * kernel_in.shape[0]
        else:
            _, T, _ = words.shape
            adcs = wibeth.unpack_frames_jnp(words)
            flat = adcs.transpose(1, 0, 2).reshape(T, C)
            padded = jnp.zeros((T, S * LANES), jnp.int32)
            padded = padded.at[:, :C].set(flat)
            kernel_in = padded.reshape(T, S, LANES)
        tc = auto_tc(T, cap=knobs["tc"])
        u = knobs["unroll"]
        # time_packed needs an even unroll (two ticks per word)
        unroll = u if (not interpret and tc % u == 0) else \
            (2 if time2_feed else 1)
        slots, nclose, stack = process_window_pallas(
            kernel_in, _stack_from_state(st, C, knobs["block_sublanes"]),
            cfg, tc=tc, k_slots=k_slots, unroll=unroll,
            interpret=interpret, time_packed=time2_feed)
        # per-link device-side decode: slots (NB, n_chunks, K, nw, SUB, 128)
        # — per-chunk slots fold into one wider slot axis (records carry
        # absolute ticks); nw=2 is the no-peak record layout
        nw = record_words(cfg)
        k_eff = slots.shape[1] * k_slots
        w = slots.transpose(1, 2, 3, 0, 4, 5) \
            .reshape(k_eff, nw, S * LANES)[:, :, :C] \
            .reshape(k_eff, nw, Lloc, N_CH).transpose(2, 0, 1, 3)
        hits, n_hits = jax.vmap(
            lambda lw: _compact_link_slots(
                lw[:, 0], lw[:, 1] if nw == 3 else None, lw[:, -1],
                max_hits_per_link))(w)
        total = jax.lax.psum(jnp.sum(n_hits), "link")
        # surface BOTH loss modes: closes beyond the per-chunk slot
        # capacity, and stored records truncated by the per-link
        # compaction bound (compact_slot_words clamps to
        # max_hits_per_link without its own overflow count)
        cap_drops = jnp.sum(jnp.maximum(nclose - k_slots, 0))
        stored = jnp.sum(jnp.minimum(nclose, k_slots)
                         .transpose(1, 0, 2, 3).reshape(-1, S * LANES),
                         axis=0)[:C].reshape(Lloc, N_CH).sum(axis=1)
        trunc = jnp.sum(jnp.maximum(stored - max_hits_per_link, 0))
        dropped = jax.lax.psum(cap_drops + trunc, "link")
        new_st = _state_from_stack(stack, C)
        new_state = {k: (new_st[k].reshape(-1, Lloc, N_CH).transpose(1, 0, 2)
                         if k == "fir_prev"
                         else new_st[k].reshape(Lloc, N_CH))
                     for k in STATE_KEYS}
        return hits, n_hits, total, dropped, new_state

    def _local(words, state):
        # words: (Lloc, T, 28); state values: (Lloc, 64)
        Lloc, T, _ = words.shape
        adcs = wibeth.unpack_frames_jnp(words)            # (Lloc, T, 64)
        flat = adcs.transpose(1, 0, 2).reshape(T, Lloc * N_CH)
        st = {k: (state[k].transpose(1, 0, 2).reshape(-1, Lloc * N_CH)
                  if k == "fir_prev" else state[k].reshape(Lloc * N_CH))
              for k in STATE_KEYS}
        closed, records, new_st = process_window_scan(flat, st, cfg)

        # shard-local per-link compaction (no cross-link coupling)
        closed_l = closed.reshape(T, Lloc, N_CH).transpose(1, 0, 2)
        records_l = {f: records[f].reshape(T, Lloc, N_CH).transpose(1, 0, 2)
                     for f in records}
        hits, n_hits, drops = jax.vmap(
            lambda c, r: compact_hits_device(c, r,
                                             max_hits=max_hits_per_link)
        )(closed_l, records_l)
        total = jax.lax.psum(jnp.sum(n_hits), "link")
        dropped = jax.lax.psum(jnp.sum(drops), "link")
        new_state = {k: (new_st[k].reshape(-1, Lloc, N_CH).transpose(1, 0, 2)
                         if k == "fir_prev"
                         else new_st[k].reshape(Lloc, N_CH))
                     for k in STATE_KEYS}
        return hits, n_hits, total, dropped, new_state

    return _local_pallas if backend == "pallas" else _local


def make_apa_step(mesh: Mesh, cfg: TPGConfig, max_hits_per_link: int = 512,
                  backend: str = "scan", k_slots: int = 8,
                  interpret: bool = False, time2_feed: bool = False):
    """Build the jitted multi-device step.

    step(words (L, T, 28) uint32, state {k: (L, 64) int32}) ->
      (hits (L, max_hits, 6) int32, n_hits (L,) int32, total_hits scalar,
       dropped scalar, new_state) — ``dropped`` counts closes lost to
      per-channel capacity (K-slot chunks in the pallas backend,
      max_hits_per_link overflow in the scan backend)

    Links shard over the mesh 'link' axis; the only collective is the psum
    for the monitoring total.  backend="pallas" runs the GPU kernel per
    shard (each device's links stack on its channel axis);
    backend="scan" is the portable XLA path.

    time2_feed=True changes the first step argument to per-DEVICE
    time-paired feeds (D, T//2, S_loc, 128) int32 (native.relayout_time2
    of each device's link group): each device consumes its shard with
    zero on-device unpack/relayout.
    """
    local = _make_local(cfg, max_hits_per_link, backend, k_slots,
                        interpret, time2_feed)
    state_spec = {k: P("link") for k in STATE_KEYS}
    step = shard_map(
        local, mesh=mesh,
        in_specs=(P("link"), state_spec),
        out_specs=(P("link"), P("link"), P(), P(), state_spec),
        check_vma=False,
    )
    return jax.jit(step)


def make_detector_step(mesh: Mesh, cfg: TPGConfig,
                       max_hits_per_link: int = 512,
                       backend: str = "scan", k_slots: int = 8,
                       interpret: bool = False, time2_feed: bool = False):
    """Build the jitted DETECTOR-scale step over a 2-D ('apa', 'link')
    mesh: N independent APAs, each sharded over its own link-axis device
    group (SURVEY §2.7 full scale-out; a far-detector module is 150 APAs).

    step(words (A, L, T, 28) uint32, state {k: (A, L, 64) int32}) ->
      (hits (A, L, max_hits, 6), n_hits (A, L), apa_totals (A,),
       dropped (A,), new_state)

    APAs never interact, so the 'apa' axis carries NO collectives at all;
    the monitoring psum stays over 'link' only, which is exactly what
    makes the aggregates PER-APA.  Each device hosts links of exactly one
    APA, enforced by requiring the mesh 'apa' axis to equal the APA
    count, so the per-shard body is byte-identical to the 1-D step's.

    With time2_feed=True the first argument is per-device feeds shaped
    (A, D_link, T//2, S_loc, 128) (relayout each device's link group).
    """
    assert mesh.axis_names == ("apa", "link"), mesh.axis_names
    local = _make_local(cfg, max_hits_per_link, backend, k_slots,
                        interpret, time2_feed)

    def local_apa(words, state):
        # leading 'apa' dim is always 1 per shard (axis size == n_apas)
        hits, n_hits, total, dropped, new_state = local(
            words[0], {k: state[k][0] for k in state})
        return (hits[None], n_hits[None], total[None], dropped[None],
                {k: new_state[k][None] for k in new_state})

    state_spec = {k: P("apa", "link") for k in STATE_KEYS}
    step = shard_map(
        local_apa, mesh=mesh,
        in_specs=(P("apa", "link"), state_spec),
        out_specs=(P("apa", "link"), P("apa", "link"), P("apa"), P("apa"),
                   state_spec),
        check_vma=False,
    )
    return jax.jit(step)


class APAPipeline:
    """Streaming APA pipeline: carries sharded per-channel state across
    batches; the host feeds packed frame batches per link."""

    def __init__(self, n_links: int, cfg: TPGConfig,
                 mesh: Optional[Mesh] = None, max_hits_per_link: int = 512,
                 backend: str = "scan", interpret: bool = False,
                 time2_feed: bool = False, codec_threads: int = 1):
        from .mesh import make_link_mesh
        self.mesh = mesh or make_link_mesh()
        self.n_links = n_links
        assert n_links % self.mesh.devices.size == 0, \
            "links must divide evenly over devices"
        if time2_feed and backend != "pallas":
            raise ValueError("time2_feed requires backend='pallas'")
        self.cfg = cfg
        self.time2_feed = time2_feed
        # host relayout codec fan-out (native.relayout_time2 nthreads=)
        self.codec_threads = codec_threads
        self._feed_buf = None              # lazy native.FeedBuffer
        self.step = make_apa_step(self.mesh, cfg, max_hits_per_link,
                                  backend=backend, interpret=interpret,
                                  time2_feed=time2_feed)
        self.state = None
        self.dropped_hits = 0      # cumulative capacity-dropped closes

    def init_state(self, first_samples: np.ndarray,
                   rs_memory_factor=None) -> None:
        """Seed per-channel state from the first time sample of each link
        ((L, 64) array; ProcessingInfo::setState semantics)."""
        if rs_memory_factor is None:
            rs_memory_factor = self.cfg.rs_memory_factor_x10
        self.cfg.check_memory_factors(rs_memory_factor)
        st = seed_chanstate(init_chanstate(self.n_links * N_CH),
                            np.asarray(first_samples).reshape(-1),
                            rs_memory_factor)
        sharding = NamedSharding(self.mesh, P("link"))

        def to_link_major(k):
            v = np.asarray(st[k], dtype=np.int32)
            if k == "fir_prev":   # (NTAPS, C) -> (L, NTAPS, 64)
                return v.reshape(-1, self.n_links, N_CH).transpose(1, 0, 2)
            return v.reshape(self.n_links, N_CH)

        self.state = {k: jax.device_put(to_link_major(k), sharding)
                      for k in STATE_KEYS}

    def process(self, words: np.ndarray):
        """words: (L, T, 28) uint32 packed ADC rows for T ticks per link.
        With time2_feed=True the host relayouts each device's link group
        (native.relayout_time2) before upload; a time2-capable source can
        call process_feed directly instead."""
        if self.state is None:
            # seed from the first tick of this batch — host-side numpy
            # unpack: nothing here may touch the default device (the mesh
            # may deliberately not be the default backend)
            from ..formats.bitpack import unpack_14bit
            adcs0 = unpack_14bit(np.asarray(words[:, 0]), N_CH).astype(np.int32)
            self.init_state(adcs0)
        if self.time2_feed:
            from .. import native
            D = self.mesh.devices.size
            Lloc = self.n_links // D
            T = words.shape[1]
            # relayout each device's link group directly into one
            # double-buffered stacked feed (native.FeedBuffer): no fresh
            # ~50 MB allocations and no np.stack copy per batch
            if self._feed_buf is None:
                self._feed_buf = native.FeedBuffer()
            feeds = self._feed_buf.get(
                (D,) + native.time2_feed_shape(Lloc, T))
            for d in range(D):
                native.relayout_time2(
                    np.ascontiguousarray(words[d * Lloc:(d + 1) * Lloc]),
                    out=feeds[d], nthreads=self.codec_threads)
            return self.process_feed(feeds)
        sharding = NamedSharding(self.mesh, P("link"))
        words = jax.device_put(np.ascontiguousarray(words), sharding)
        hits, n_hits, total, dropped, self.state = self.step(words,
                                                             self.state)
        self.dropped_hits += int(dropped)
        return hits, n_hits, int(total)

    def process_feed(self, feeds: np.ndarray):
        """feeds: (D, T//2, S_loc, 128) int32 per-device time-paired
        shards (time2_feed mode; state must already be seeded)."""
        assert self.time2_feed and self.state is not None
        sharding = NamedSharding(self.mesh, P("link"))
        feeds = jax.device_put(np.ascontiguousarray(feeds), sharding)
        hits, n_hits, total, dropped, self.state = self.step(feeds,
                                                             self.state)
        self.dropped_hits += int(dropped)
        return hits, n_hits, int(total)


class DetectorPipeline:
    """Detector-scale streaming pipeline: N independent APAs over a 2-D
    ('apa', 'link') mesh, each APA sharded over its own link-axis device
    group.  Per-APA hit totals come out of the step's link-only psum; the
    'apa' axis never communicates (APAs are physically independent)."""

    def __init__(self, n_apas: int, links_per_apa: int, cfg: TPGConfig,
                 mesh: Optional[Mesh] = None, max_hits_per_link: int = 512,
                 backend: str = "scan", interpret: bool = False,
                 time2_feed: bool = False, codec_threads: int = 1):
        from .mesh import make_apa_link_mesh
        self.mesh = mesh or make_apa_link_mesh(n_apas)
        shape = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        if shape.get("apa") != n_apas:
            raise ValueError(
                f"mesh 'apa' axis ({shape.get('apa')}) must equal n_apas "
                f"({n_apas}): each device hosts links of exactly one APA")
        if links_per_apa % shape["link"]:
            raise ValueError("links_per_apa must divide evenly over the "
                             "mesh 'link' axis")
        if time2_feed and backend != "pallas":
            raise ValueError("time2_feed requires backend='pallas'")
        self.cfg = cfg
        self.n_apas = n_apas
        self.links_per_apa = links_per_apa
        self.time2_feed = time2_feed
        # host codec fan-out PER relayout call; at detector scale A*D
        # serial calls per batch make the host codec the bottleneck
        # without it (production sizing: ~2 cores per APA, docs/SIZING)
        self.codec_threads = codec_threads
        self._feed_buf = None
        self.step = make_detector_step(
            self.mesh, cfg, max_hits_per_link, backend=backend,
            interpret=interpret, time2_feed=time2_feed)
        self.state = None
        self.dropped_hits = np.zeros(n_apas, dtype=np.int64)  # per APA

    def init_state(self, first_samples: np.ndarray,
                   rs_memory_factor=None) -> None:
        """Seed per-channel state from each APA's first time sample
        ((A, L, 64) array).  ``rs_memory_factor`` is per-APA-shared
        (scalar or (L*64,) — every APA has the same plane geometry)."""
        if rs_memory_factor is None:
            rs_memory_factor = self.cfg.rs_memory_factor_x10
        self.cfg.check_memory_factors(rs_memory_factor)
        A, L = self.n_apas, self.links_per_apa
        first = np.asarray(first_samples).reshape(A, L * N_CH)
        per_apa = [seed_chanstate(init_chanstate(L * N_CH), first[a],
                                  rs_memory_factor) for a in range(A)]
        sharding = NamedSharding(self.mesh, P("apa", "link"))

        def to_apa_link_major(k):
            v = np.stack([np.asarray(st[k], dtype=np.int32)
                          for st in per_apa])
            if k == "fir_prev":   # (A, NTAPS, C) -> (A, L, NTAPS, 64)
                return v.reshape(A, -1, L, N_CH).transpose(0, 2, 1, 3)
            return v.reshape(A, L, N_CH)

        self.state = {k: jax.device_put(to_apa_link_major(k), sharding)
                      for k in STATE_KEYS}

    def process(self, words: np.ndarray):
        """words: (A, L, T, 28) uint32 packed ADC rows, one row block per
        (apa, link).  Returns (hits (A, L, max_hits, 6), n_hits (A, L),
        apa_totals (A,) int)."""
        A, L = self.n_apas, self.links_per_apa
        assert words.shape[:2] == (A, L), words.shape
        if self.state is None:
            from ..formats.bitpack import unpack_14bit
            adcs0 = unpack_14bit(
                np.asarray(words[:, :, 0]).reshape(A * L, -1),
                N_CH).astype(np.int32)
            self.init_state(adcs0.reshape(A, L, N_CH))
        if self.time2_feed:
            from .. import native
            D = dict(zip(self.mesh.axis_names,
                         self.mesh.devices.shape))["link"]
            Lloc = L // D
            T = words.shape[2]
            if self._feed_buf is None:
                self._feed_buf = native.FeedBuffer()
            feeds = self._feed_buf.get(
                (A, D) + native.time2_feed_shape(Lloc, T))
            for a in range(A):
                for d in range(D):
                    native.relayout_time2(
                        np.ascontiguousarray(
                            words[a, d * Lloc:(d + 1) * Lloc]),
                        out=feeds[a, d], nthreads=self.codec_threads)
            upload = feeds
        else:
            upload = np.ascontiguousarray(words)
        sharding = NamedSharding(self.mesh, P("apa", "link"))
        upload = jax.device_put(upload, sharding)
        hits, n_hits, totals, dropped, self.state = self.step(upload,
                                                              self.state)
        self.dropped_hits += np.asarray(dropped, dtype=np.int64)
        return hits, n_hits, np.asarray(totals, dtype=np.int64)
