"""A small EDN reader/writer.

The reference's native workload drivers emit Jepsen histories as EDN — a
vector of keyword maps (``linearizable/ctest/register.c:282-307``) — and
the offline checker reads them back with ``read-string``
(``linearizable/filetest/src/jepsen/filetest.clj:8-21``). This module
gives the framework the same interchange format without a Clojure
dependency.

Supported: nil / true / false, integers, floats, strings, keywords,
symbols (as strings), vectors, lists, maps, sets, and ``;`` comments.
Tagged literals are read by dropping the tag. That covers everything the
reference's history files contain.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Tuple


class Keyword(str):
    """An EDN keyword. Subclasses str, so a keyword compares equal to its
    name: ``kw("read") == "read"`` is True. This is deliberate — host code
    never needs ``op[":type"]``-style juggling.
    """

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f":{str.__str__(self)}"


_KW_CACHE: dict = {}


def kw(name: str) -> Keyword:
    k = _KW_CACHE.get(name)
    if k is None:
        k = Keyword(name)
        _KW_CACHE[name] = k
    return k


_DELIMS = set('()[]{}"; \t\n\r,')


def _tokenize(s: str) -> Iterator[Tuple[str, Any]]:
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c in " \t\n\r,":
            i += 1
        elif c == ";":
            while i < n and s[i] != "\n":
                i += 1
        elif c == '"':
            j = i + 1
            buf = []
            closed = False
            while j < n:
                ch = s[j]
                if ch == "\\":
                    if j + 1 >= n:
                        raise ValueError("truncated escape in string")
                    esc = s[j + 1]
                    buf.append({"n": "\n", "t": "\t", "r": "\r", '"': '"',
                                "\\": "\\"}.get(esc, esc))
                    j += 2
                elif ch == '"':
                    closed = True
                    break
                else:
                    buf.append(ch)
                    j += 1
            if not closed:
                raise ValueError("unterminated string")
            yield ("str", "".join(buf))
            i = j + 1
        elif c in "([{":
            yield ("open", c)
            i += 1
        elif c in ")]}":
            yield ("close", c)
            i += 1
        elif c == "#":
            if i + 1 < n and s[i + 1] == "{":
                yield ("open", "#{")
                i += 2
            elif i + 1 < n and s[i + 1] == "_":
                yield ("discard", None)
                i += 2
            else:
                # tagged literal tag: read the symbol and drop it
                j = i + 1
                while j < n and s[j] not in _DELIMS:
                    j += 1
                yield ("tag", s[i + 1:j])
                i = j
        elif c == "\\":  # character literal
            j = i + 1
            while j < n and s[j] not in _DELIMS:
                j += 1
            name = s[i + 1:j]
            yield ("atom", {"newline": "\n", "space": " ", "tab": "\t"}.get(
                name, name[:1]))
            i = j
        else:
            j = i
            while j < n and s[j] not in _DELIMS:
                j += 1
            yield ("sym", s[i:j])
            i = j


def _parse_sym(tok: str) -> Any:
    if tok == "nil":
        return None
    if tok == "true":
        return True
    if tok == "false":
        return False
    if tok.startswith(":"):
        return kw(tok[1:])
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        if tok.endswith("N") or tok.endswith("M"):
            return int(tok[:-1])
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # bare symbol → string


class _Reader:
    def __init__(self, tokens: List[Tuple[str, Any]]):
        self.tokens = tokens
        self.pos = 0

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self):
        t = self.tokens[self.pos]
        self.pos += 1
        return t

    def skip_discards(self):
        """Consume any number of ``#_ form`` pairs before the next real
        form; collections call this so a trailing discard (``[1 #_2]``)
        doesn't swallow the closing delimiter."""
        while True:
            p = self.peek()
            if p is None or p[0] != "discard":
                return
            self.next()
            self.read()  # the discarded form

    def read(self) -> Any:
        self.skip_discards()
        if self.peek() is None:
            raise ValueError("unexpected end of input")
        kind, val = self.next()
        if kind == "sym":
            return _parse_sym(val)
        if kind in ("str", "atom"):
            return val
        if kind == "tag":
            return self.read()  # drop the tag, keep the form
        if kind == "open":
            if val == "(" or val == "[":
                out = []
                while True:
                    self.skip_discards()
                    p = self.peek()
                    if p is None:
                        raise ValueError("unterminated collection")
                    if p[0] == "close":
                        self.next()
                        return out
                    out.append(self.read())
            if val == "{":
                items = []
                while True:
                    self.skip_discards()
                    p = self.peek()
                    if p is None:
                        raise ValueError("unterminated map")
                    if p[0] == "close":
                        self.next()
                        if len(items) % 2:
                            raise ValueError("odd number of map elements")
                        return {_hashable(items[i]): items[i + 1]
                                for i in range(0, len(items), 2)}
                    items.append(self.read())
            if val == "#{":
                out = set()
                while True:
                    self.skip_discards()
                    p = self.peek()
                    if p is None:
                        raise ValueError("unterminated set")
                    if p[0] == "close":
                        self.next()
                        return out
                    out.add(_hashable(self.read()))
        raise ValueError(f"unexpected token {kind} {val!r}")


def _hashable(x: Any) -> Any:
    return tuple(_hashable(e) for e in x) if isinstance(x, list) else x


def read_edn(s: str) -> Any:
    """Read one EDN form from a string."""
    return _Reader(list(_tokenize(s))).read()


def read_edn_all(s: str) -> List[Any]:
    """Read every top-level EDN form in a string (e.g. one-op-per-line
    history files)."""
    r = _Reader(list(_tokenize(s)))
    out = []
    while True:
        r.skip_discards()
        if r.peek() is None:
            return out
        out.append(r.read())


def write_edn(x: Any) -> str:
    """Serialize a Python value as EDN text."""
    if x is None:
        return "nil"
    if x is True:
        return "true"
    if x is False:
        return "false"
    if isinstance(x, Keyword):
        return f":{str.__str__(x)}"
    if isinstance(x, str):
        return '"' + x.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(x, (int, float)):
        return repr(x)
    if isinstance(x, (list, tuple)):
        return "[" + " ".join(write_edn(e) for e in x) + "]"
    if isinstance(x, (set, frozenset)):
        return "#{" + " ".join(write_edn(e) for e in sorted(x, key=repr)) + "}"
    if isinstance(x, dict):
        return "{" + ", ".join(
            f"{write_edn(k)} {write_edn(v)}" for k, v in x.items()) + "}"
    raise TypeError(f"cannot serialize {type(x)} as EDN")
