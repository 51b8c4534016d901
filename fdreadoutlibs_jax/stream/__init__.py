"""L3 — frame processors and the host streaming harness.

Equivalent of the reference's TaskRawDataProcessorModel specializations
(WIBEthFrameProcessor, WIB2FrameProcessor, DAPHNE/TDE/SSP processors) plus
the implied readoutlibs runtime pieces the reference compiles against
(SURVEY.md §2.6): pre/postprocess pipelines with conf/start/stop/get_info
lifecycle, emulator mode, frame-error registry, typed non-blocking senders.

Accelerator shape: processors consume *batches* of frames (numpy arrays of
payload bytes) per call — header validation is vectorized on host, the SWTPG
hot path runs on device via the scan or Pallas backend, TP assembly is
vectorized numpy.
"""

from .errors import (FrameErrorRegistry, FDReadoutError,  # noqa: F401
                     TPGAlgorithmInexistent, TPTooLong, FailedToSendTP,
                     LinkMisconfiguration)
from .transport import Sender, QueueSender, CallbackSender  # noqa: F401
from .processor import TaskRawDataProcessor  # noqa: F401
from .wibeth import WIBEthFrameProcessor  # noqa: F401
from .wib2 import WIB2FrameProcessor  # noqa: F401
from .protowib import WIBFrameProcessor  # noqa: F401
from .daphne import DAPHNEFrameProcessor, DAPHNEStreamFrameProcessor  # noqa: F401
from .tde import TDEFrameProcessor  # noqa: F401
from .ssp import SSPFrameProcessor, SWTriggerPrimitiveProcessor  # noqa: F401
