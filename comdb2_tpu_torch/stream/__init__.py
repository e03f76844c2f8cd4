"""Streaming verification sessions — device-resident incremental
checking of live histories.

The counterpart of the JAX package's ``stream``. Every other entry
point of the package is post-hoc batch (collect, then verify); this
one verifies a history *as it happens*: a long-lived
:class:`StreamSession` owns a frontier carry on the device,
``append(ops)`` packs only the delta as a columnar slice, segments
only the new suffix, and dispatches only the new segments against the
resident carry — per-append cost is O(delta), never O(history). The
carry rungs are the segment-search kernel (``kernels/seg_search.cu``
in carry mode), the seg2 engine and the MXU engine
(:mod:`.engine`); bank and sets histories run as workload sessions
(:mod:`.wl`). Offline it is ``python -m comdb2_tpu_torch.filetest
--follow``.
"""

from .ingest import MalformedDelta, StreamIngest
from .manager import SessionLimit, SessionManager
from .segment import StreamSegmenter
from .session import StreamSession

__all__ = ["MalformedDelta", "SessionLimit", "SessionManager",
           "StreamIngest", "StreamSegmenter", "StreamSession"]
