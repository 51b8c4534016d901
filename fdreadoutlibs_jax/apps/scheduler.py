"""Multi-APA time-multiplexing scheduler — serve N APAs on one device.

The reference dedicates one CPU thread per ~64-256 channels, so an APA
consumes a whole multi-core host (SURVEY.md §6).  This scheduler
round-robins batches from several APAs through ONE compiled ingest
executable.  Because all per-channel state is functional
(a packed stack array passed in and out of the kernel), "context switch"
is nothing more than passing a different APA's stack to the same jit —
no recompilation, no state copies, no cache flush.

Dispatch is asynchronous: submitting APA k's batch enqueues device work
and immediately returns the *previous* result for APA k once it is
needed, so host framing of one APA overlaps device compute of another
(same double-buffering idea as ops/ingest.StreamingIngest, per APA).
"""

from __future__ import annotations

import numpy as np

from ..formats import wibeth
from ..ops.config import TPGConfig


class MultiAPAScheduler:
    """Round-robin N independent APA streams through one compiled kernel.

    Every APA must present the same geometry (n_links links of 64
    channels) so all calls hit the same executable; per-APA state stacks
    live on device between calls.
    """

    def __init__(self, cfg: TPGConfig, n_apas: int, n_links: int = 40,
                 tc: int | None = None, k_slots: int = 2,
                 unroll: int | None = None,
                 interpret: bool = False, rs_memory_factor=None):
        self.cfg = cfg
        # per-channel RS memory factors (threshold-on-collection), shared
        # by every APA (same geometry); scalar default = cfg value
        if rs_memory_factor is None:
            rs_memory_factor = cfg.rs_memory_factor_x10
        else:
            rs_memory_factor = np.asarray(rs_memory_factor)
            n_ch = n_links * wibeth.N_CHANNELS
            if rs_memory_factor.shape != (n_ch,):
                raise ValueError(
                    f"rs_memory_factor must be scalar or ({n_ch},), "
                    f"got shape {rs_memory_factor.shape}")
            cfg.check_memory_factors(rs_memory_factor)
        self.rs_memory_factor = rs_memory_factor
        self.n_apas = n_apas
        self.n_links = n_links
        self.n_channels = n_links * wibeth.N_CHANNELS
        # explicit args win; else tuned file (FDREADOUT_TUNED); else
        # the shipped per-algorithm table
        from ..utils.tuning import kernel_knobs
        knobs = kernel_knobs(cfg, self.n_channels, tc=tc, unroll=unroll)
        self.tc = knobs["tc"]
        self.k_slots = k_slots
        self.unroll = knobs["unroll"]
        self.interpret = interpret
        self._stacks = [None] * n_apas          # per-APA device state
        self._pending = [None] * n_apas         # (slots, nclose, tick_off)
        self._tick_offset = [0] * n_apas
        self._batches = [0] * n_apas

    def _ensure_state(self, apa: int, words: np.ndarray) -> None:
        import jax.numpy as jnp
        from ..ops.chanstate import init_chanstate, seed_chanstate
        from ..ops.pallas_tpg import pack_state
        first = np.asarray(wibeth.unpack_frames_jnp(
            jnp.asarray(words[:, :1])))[:, 0].reshape(-1)
        state = seed_chanstate(init_chanstate(self.n_channels), first,
                               self.rs_memory_factor)
        from ..utils.tuning import kernel_knobs
        self._stacks[apa] = pack_state(
            state, self.n_channels,
            block_sublanes=kernel_knobs(
                self.cfg, self.n_channels)["block_sublanes"])

    def submit(self, apa: int, frames_links: np.ndarray):
        """frames_links: (L, N, 7200) one batch for one APA.  Returns the
        decoded hits of THIS APA's previous batch (pipelined), or None."""
        from ..ops.ingest import host_words
        L, N, _ = frames_links.shape
        if L != self.n_links:
            raise ValueError(f"APA {apa}: expected {self.n_links} links, "
                             f"got {L}")
        T = N * wibeth.N_TIME_SAMPLES
        words = host_words(frames_links.reshape(-1, wibeth.FRAME_SIZE)) \
            .reshape(L, T, 28)
        return self.submit_words(apa, words)

    def submit_words(self, apa: int, words: np.ndarray):
        import jax.numpy as jnp
        from ..ops.ingest import process_packed_frames
        from ..ops.pallas_tpg import auto_tc
        L, T, _ = words.shape
        if self._stacks[apa] is None:
            self._ensure_state(apa, words)
        out = self.collect(apa)
        tc = auto_tc(T, cap=self.tc)
        slots, nclose, self._stacks[apa] = process_packed_frames(
            jnp.asarray(words), self._stacks[apa], self.cfg,
            self.n_channels, tc=tc, k_slots=self.k_slots,
            unroll=self.unroll if (not self.interpret and
                                   tc % self.unroll == 0) else 1,
            interpret=self.interpret)
        self._pending[apa] = (slots, nclose, self._tick_offset[apa])
        self._tick_offset[apa] += T
        self._batches[apa] += 1
        return out

    def collect(self, apa: int):
        """Block on and decode APA ``apa``'s in-flight batch, if any."""
        if self._pending[apa] is None:
            return None
        from ..ops.pallas_tpg import decode_pallas_hits
        slots, nclose, tick_offset = self._pending[apa]
        self._pending[apa] = None
        hits, dropped = decode_pallas_hits(slots, nclose, self.n_channels,
                                           tick_offset=tick_offset)
        return hits, dropped

    def flush(self):
        """Collect every APA's in-flight batch: {apa: (hits, dropped)}."""
        out = {}
        for apa in range(self.n_apas):
            got = self.collect(apa)
            if got is not None:
                out[apa] = got
        return out

    def get_info(self) -> dict:
        return {"n_apas": self.n_apas,
                "n_channels_per_apa": self.n_channels,
                "batches": list(self._batches),
                "ticks": list(self._tick_offset)}
