"""Operation & history core.

Semantics follow the reference's knossos/op.clj and knossos/history.clj;
the packed struct-of-arrays form is what the checker consumes.
"""

from .op import (
    Op,
    INVOKE,
    OK,
    FAIL,
    INFO,
    TYPE_NAMES,
    invoke,
    ok,
    fail,
    info,
    is_invoke,
    is_ok,
    is_fail,
    is_info,
)
from .history import complete, index, pairs, pair_index, processes
from .edn import read_edn, read_edn_all, write_edn, Keyword, kw
from .packed import PackedHistory, pack_history

__all__ = [
    "Op", "INVOKE", "OK", "FAIL", "INFO", "TYPE_NAMES",
    "invoke", "ok", "fail", "info",
    "is_invoke", "is_ok", "is_fail", "is_info",
    "complete", "index", "pairs", "pair_index", "processes",
    "read_edn", "read_edn_all", "write_edn", "Keyword", "kw",
    "PackedHistory", "pack_history",
]
