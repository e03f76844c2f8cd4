"""Harness runtime: generator DSL, client/DB/OS protocols, worker &
nemesis loops with indeterminacy-driven process recycling, results
store, and CLI — the capabilities of ``jepsen/{core,generator,client,
db,os,store,cli,tests}.clj``.

The counterpart of the JAX package's ``harness`` package, in-process
half: everything but the TCP cluster's modules (provisioning, cluster
kill, the web browser, fake time and the time nemesis). The harness
touches no device; the checkers a test composes do.
"""

from . import generator
from . import client
from . import db
from . import core
from . import store
from . import fake
from . import cli
from . import nemesis
from . import cluster
from .core import run, run_case

__all__ = ["generator", "client", "db", "core", "store", "fake", "cli",
           "nemesis", "cluster", "run", "run_case"]
