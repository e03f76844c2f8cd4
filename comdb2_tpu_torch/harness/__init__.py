"""Harness runtime: generator DSL, client/DB/OS protocols, worker &
nemesis loops with indeterminacy-driven process recycling, results
store, and CLI — the capabilities of ``jepsen/{core,generator,client,
db,os,store,cli,tests}.clj``.

The counterpart of the JAX package's ``harness`` package, with the
same exports: the in-process runner and the TCP cluster's modules
(provisioning in :mod:`.provision`, cluster kill-restart in
:mod:`.killcluster`, fake time, the time nemesis, OS setup, the repl
helpers and the store's web browser). The harness touches no device;
the checkers a test composes do.
"""

from . import generator
from . import client
from . import db
from . import core
from . import store
from . import fake
from . import cli
from . import nemesis
from . import nemesis_time
from . import cluster
from . import faketime
from . import killcluster
from . import web
from .core import run, run_case

__all__ = ["generator", "client", "db", "core", "store", "fake", "cli",
           "nemesis", "nemesis_time", "cluster", "faketime",
           "killcluster", "web", "run", "run_case"]
