"""``comdb2_tpu_torch.service`` — the verification serving layer.

The counterpart of the JAX package's ``service``, over the port's
engines: many histories ride one device dispatch, so a persistent
daemon batches its callers' requests onto the batch entry points
(:mod:`comdb2_tpu_torch.checker.batch`):

- :mod:`.protocol`   — newline-JSON framing over TCP.
- :mod:`.bucketing`  — shape quantization into a small, closed set of
  buckets, the units requests coalesce under.
- :mod:`.core`       — continuous-batching admission (slot-filling
  launches, the bounded in-flight ring), backpressure/deadlines,
  host-engine degradation, metrics.
- :mod:`.daemon`     — the selector/pump loop; ``python -m
  comdb2_tpu_torch.service`` runs it (pmux discovery, store artifacts).
- :mod:`.client`     — retrying client with overload backoff, plus
  the consistent-hash :class:`~.client.RoutedClient` over a
  pmux-discovered fleet; ``filetest --service`` uses the former.
- :mod:`.supervisor` — spawns, drains, reaps and sizes a fleet.
- :mod:`.sharding`   — device meshes (a pow2 tuple of devices, one
  launch per device).
"""

from .bucketing import Bucket, ServiceLimits, bucket_for     # noqa: F401
from .core import DEFAULT_PRIME, VerifierCore                # noqa: F401

__all__ = ["Bucket", "DEFAULT_PRIME", "ServiceLimits",
           "VerifierCore", "bucket_for"]
