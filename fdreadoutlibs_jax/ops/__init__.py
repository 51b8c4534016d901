"""L2 — SWTPG kernel layer.

One parameterized core replaces the reference's three copy-pasted C++
namespaces (swtpg / swtpg_wib2 / swtpg_wibeth).  Three interchangeable,
bit-identical implementations of the same streaming pipeline:

* ``reference``  — numpy oracle (vectorized over channels, Python time loop);
* ``scan``       — pure-XLA ``lax.scan`` (jit-able anywhere, incl. CPU mesh);
* ``pallas_tpg`` — Pallas kernel compiled through Triton for the GPU
  (production hot path on the card).

Shared pieces: ``fixedpoint`` (exact int16 arithmetic emulation),
``chanstate`` (the persistent per-channel state pytree), ``hits`` (record
decode/compaction), ``patterns`` (golden/pulse/edge validation patterns).
"""

from . import fixedpoint  # noqa: F401
from .chanstate import ChanState, init_chanstate, seed_chanstate  # noqa: F401
from .config import TPGConfig, Algorithm  # noqa: F401
