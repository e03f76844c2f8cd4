"""The port's native EDN loader (``ops/native_loader.py``) against the
Python reader and the JAX package's loader.

The parity tests need ``native/build/libct_sut.so`` (``cmake -S native
-B native/build && cmake --build native/build``) and skip without it,
like the JAX package's own. The fallback tests run everywhere: with no
library every text goes through the port's Python reader and says so.
"""

import random
from pathlib import Path

import pytest

from comdb2_tpu.ops import native_loader as JNL

from comdb2_tpu_torch.ops import history as H
from comdb2_tpu_torch.ops import native_loader as NL
from comdb2_tpu_torch.ops.synth import (list_append_history, mutate,
                                         register_history)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
EDN_FIXTURES = sorted((FIXTURES / "txn").glob("*.edn")) + \
    sorted((FIXTURES / "wl").glob("*.edn"))

CTEST_EDN = """[
{:type :invoke :f :read :value nil :process 0 :time 10}
{:type :ok :f :read :value 3 :process 0 :uid 7 :time 20}
{:type :invoke :f :cas :value [2 4] :process 1 :time 30}
{:type :fail :f :cas :value [2 4] :process 1 :time 40}
{:type :invoke :f :write :value [1 [0 3]] :process 2 :time 50}
{:type :info :f :write :value [1 [0 3]] :process 2 :time 60}
{:type :invoke :f :add :value [5 nil] :process 3 :time 70}
]
"""


@pytest.fixture()
def native():
    if not NL.native_available():
        pytest.skip("native/build/libct_sut.so not built")


def _fields(ops):
    return [(o.process, o.type, o.f, o.value, o.time) for o in ops]


def _generated():
    h = register_history(random.Random(4), n_procs=5, n_events=300,
                         values=5, p_info=0.1)
    return [H.history_to_edn(h),
            H.history_to_edn(mutate(random.Random(4), h, values=5)),
            H.history_to_edn(list_append_history(random.Random(5),
                                                 n_txns=20))]


def test_native_matches_python_reader(native):
    info = {}
    fast = NL.parse_history_fast(CTEST_EDN, info=info)
    assert info == {"parser": "native"}
    slow = H.parse_history(CTEST_EDN)
    assert len(fast) == len(slow) == 7
    assert _fields(fast) == _fields(slow)
    assert fast[4].value == (1, (0, 3))
    assert fast[6].value == (5, None)


@pytest.mark.parametrize("path", EDN_FIXTURES, ids=lambda p: p.name)
def test_fixtures_parse_alike(native, path):
    text = path.read_text()
    got = _fields(NL.parse_history_fast(text))
    assert got == _fields(H.parse_history(text))
    assert got == _fields(JNL.parse_history_fast(text))


@pytest.mark.parametrize("i", range(3))
def test_generated_histories_parse_alike(native, i):
    text = _generated()[i]
    got = _fields(NL.parse_history_fast(text))
    assert got == _fields(H.parse_history(text))
    assert got == _fields(JNL.parse_history_fast(text))


def test_native_falls_back_outside_subset(native):
    # string values are valid EDN but outside the fast subset
    info = {}
    ops = NL.parse_history_fast(
        '{:type :invoke :f :read :value "weird" :process 0 :time 1}',
        info=info)
    assert [o.value for o in ops] == ["weird"]
    assert info == {"parser": "python"}


def test_native_edge_values_match_python(native):
    """Shapes that once diverged: inner-vector-not-last, out-of-range
    ints, and INT64_MIN (the nil sentinel) must fall back, never skew."""
    for edn in [
        "{:type :invoke :f :x :value [1 [2 3] 4] :process 0 :time 1}",
        "{:type :invoke :f :x :value 9223372036854775808 "
        ":process 0 :time 1}",
        "{:type :invoke :f :x :value -9223372036854775808 "
        ":process 0 :time 1}",
    ]:
        assert [o.value for o in NL.parse_history_fast(edn)] == \
            [o.value for o in H.parse_history(edn)], edn


def test_native_rejects_malformed_gracefully(native):
    with pytest.raises(Exception):
        NL.parse_history_fast("{:type :invoke :f }")


@pytest.mark.parametrize("i", range(3))
def test_without_the_library_the_python_reader_parses(monkeypatch, i):
    monkeypatch.setattr(NL, "_LIB", None)
    monkeypatch.setattr(NL, "_LIB_TRIED", True)
    assert not NL.native_available()
    text = _generated()[i]
    info = {}
    assert _fields(NL.parse_history_fast(text, info=info)) == \
        _fields(H.parse_history(text))
    assert info == {"parser": "python"}
