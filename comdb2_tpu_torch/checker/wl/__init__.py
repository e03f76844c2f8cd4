"""Device workload-checker families — bank / sets / dirty-reads.

The counterpart of the JAX package's ``checker/wl``: the Jepsen checker
suite beside the register tester, lowered from the per-op host loops in
``checker/workloads.py`` to batched tensor reductions. None of these
needs a frontier search, so a whole batch of histories is ONE device
call of torch ops per pow2 bucket (``check_wl_batch``). The host
checkers remain as parity oracles: a device verdict must say what the
oracle's says on every seeded valid / violation twin
(``agrees_with_oracle``).

Not ported yet: the stream rungs' delta and megabatch forms
(``wl_*_delta``, ``wl_*_delta_mb``); they go with streaming.
"""

from .bank import (BankColumns, bank_verdicts, default_init,
                   encode_bank, wl_bank_check)
from .batch import (FAMILIES, WL_ACCOUNTS, WL_BATCH, WL_ELEMS, WL_NODES,
                    WL_READS, WL_SNAPS, WL_VALUES, agrees_with_oracle,
                    bucket_of, check_wl_batch, stage_wl_batch, wl_dims)
from .dirty import (DirtyColumns, dirty_verdicts, encode_dirty,
                    is_malformed_read, wl_dirty_check)
from .sets import SetsColumns, encode_sets, sets_verdicts, wl_sets_check
from .synth import bank_batch, dirty_batch, sets_batch

__all__ = ["BankColumns", "DirtyColumns", "FAMILIES", "SetsColumns",
           "WL_ACCOUNTS", "WL_BATCH", "WL_ELEMS", "WL_NODES", "WL_READS",
           "WL_SNAPS", "WL_VALUES", "agrees_with_oracle", "bank_batch",
           "bank_verdicts", "bucket_of", "check_wl_batch", "default_init",
           "dirty_batch", "dirty_verdicts", "encode_bank", "encode_dirty",
           "encode_sets", "is_malformed_read", "sets_batch",
           "sets_verdicts", "stage_wl_batch", "wl_bank_check", "wl_dims",
           "wl_dirty_check", "wl_sets_check"]
