"""Link-axis data parallelism over device meshes.

The reference's parallelism inventory (SURVEY.md §2.7) maps to pure
data parallelism over readout links: an APA is 40 WIBEth streams x 64
channels; links shard across devices on a 1-D ``jax.sharding.Mesh`` with NO
collectives in the hot loop (per-channel streaming state is embarrassingly
parallel — the only cross-channel coupling in the whole pipeline is hit
output compaction, which stays shard-local).  ``psum`` appears only for
monitoring aggregates.

Detector scale-out stacks a second, collective-free 'apa' mesh axis on
top: ``DetectorPipeline`` runs N independent APAs over a 2-D
('apa', 'link') mesh, one device group per APA, with the
monitoring psum still riding 'link' only (per-APA totals for free).
"""

from .mesh import make_apa_link_mesh, make_link_mesh  # noqa: F401
from .apa import (APAPipeline, DetectorPipeline,  # noqa: F401
                  make_apa_step, make_detector_step)
