"""fdreadoutlibs_jax — JAX software trigger-primitive generation (SWTPG).

A ground-up JAX/XLA/Pallas rebuild of the capabilities of DUNE-DAQ's
``fdreadoutlibs`` (reference: /root/reference): far-detector frame-format
type adapters (WIBEth / WIB2 / ProtoWIB / DAPHNE / DAPHNE-stream / TDE / SSP /
TriggerPrimitive), the software TPG kernel families (frugal-streaming pedestal
subtraction, running-sum and FIR filtering, threshold hit finding with
persistent per-channel state), frame processors (sequence/timestamp validation,
emulator mode, TP assembly), and TP/TPSet request handling — designed for
an accelerator (an NVIDIA GPU; the CPU runs the portable XLA path):

* arrays + pure functions + explicit carried state instead of class towers;
* one parameterized SWTPG core instead of three copy-pasted C++ namespaces;
* channels as the parallel axis, time as a sequential loop (a Pallas
  kernel compiled through Triton, one channel block per program with the
  state in registers), links as a batch/mesh axis;
* multi-device scale-out as pure data parallelism over links on a
  ``jax.sharding.Mesh`` (no collectives in the hot loop).

Layer map (mirrors SURVEY.md):
  ``formats/``  — L1 type adapters: frame geometry, bit-packing codecs, headers
  ``ops/``      — L2 TPG kernels: fixed point, frugal streaming, scan, Pallas
  ``models/``   — L2 algorithm families: SimpleThreshold, AbsRS, StandardRS, FIR
  ``stream/``   — L3 frame processors + host streaming harness
  ``tp/``       — L4 TP buffering, TPSet windowing, data requests
  ``parallel/`` — link-axis sharding over device meshes
  ``utils/``    — channel maps, config, metrics, logging
"""

__version__ = "0.1.0"
