"""Control plane. The port holds the pmux client so far
(:mod:`.pmux`): service-name to port discovery, which the verifier
daemon and its clients use."""

from .pmux import PmuxClient, resolve_layout  # noqa: F401

__all__ = ["PmuxClient", "resolve_layout"]
