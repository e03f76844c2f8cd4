"""Workloads: the comdb2 test suite over a table-level SUT interface.

- :mod:`comdb2_tpu_torch.workloads.sqlish` — serializable connection protocol
  + in-memory backend with chaos injection
- :mod:`comdb2_tpu_torch.workloads.comdb2` — cas-register, bank, sets,
  dirty-reads, G2 workloads and their testers

The counterpart of the JAX package's ``workloads`` package, with the
same exports; its TCP and SQL clients of the replicated ``sut_node``
cluster are the modules :mod:`.tcp` and :mod:`.sql`, imported by name.
"""

from . import sqlish
from . import comdb2

__all__ = ["sqlish", "comdb2"]
