"""Shared helpers of the harness slice's parity tests
(``tests/test_torch_{harness,generator,control,workloads,report_perf}.py``):
moving ops between the two packages' classes and comparing result maps
across them."""

import torch

from comdb2_tpu.ops import kv as JKV
from comdb2_tpu.ops import op as JO

from comdb2_tpu_torch.ops import kv as TKV
from comdb2_tpu_torch.ops import op as TO

#: what a linearizability result names about the engine that produced
#: it rather than about the history: the engine and its device, the
#: frontier capacity it stopped at, the engines tried on the way and
#: the wall time. The JAX package on CPU takes its XLA or MXU engine;
#: the port takes its kernel's plain version at 128 first.
ENGINE_KEYS = ("engine", "device", "frontier_capacity", "engines_tried",
               "time_s")


def one_torch_thread():
    """A module fixture's body: pin one torch thread (torch's CPU ops
    fan out to every core and cost milliseconds a call on a busy
    host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _value(v, src_kv, dst):
    if isinstance(v, src_kv.KVTuple):
        return dst.tuple_(v.key, v.value)
    return v


def _convert(h, src_kv, dst_kv, dst_op):
    return [dst_op.Op(process=o.process, type=o.type, f=o.f,
                      value=_value(o.value, src_kv, dst_kv),
                      index=o.index, time=o.time, fails=o.fails,
                      extra=dict(o.extra))
            for o in h]


def to_jax(history):
    """A port history as the JAX package's ops (keyed values as its
    ``KVTuple``)."""
    return _convert(history, TKV, JKV, JO)


def to_torch(history):
    """A JAX package history as the port's ops."""
    return _convert(history, JKV, TKV, TO)


def op_fields(op, time=True):
    """An op of either package as a plain tuple (keyed values marked)."""
    v = op.value
    if isinstance(v, (TKV.KVTuple, JKV.KVTuple)):
        v = ("kv", v.key, v.value)
    out = (op.process, op.type, op.f, v, op.index, op.fails,
           tuple(sorted(op.extra.items())))
    return out + (op.time,) if time else out


def plain(x):
    """A result map of either package with ops as their maps, keyed
    values marked and engine labels (:data:`ENGINE_KEYS`) dropped, so
    the two packages' maps compare with ``==``."""
    if isinstance(x, (TO.Op, JO.Op)):
        return ("op",) + op_fields(x)
    if isinstance(x, (TKV.KVTuple, JKV.KVTuple)):
        return ("kv", plain(x.key), plain(x.value))
    if hasattr(x, "describe"):          # a model
        return x.describe()
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items() if k not in ENGINE_KEYS}
    if isinstance(x, list):
        return [plain(v) for v in x]
    if isinstance(x, tuple):
        return tuple(plain(v) for v in x)
    return x


def gen_stream(gen_mod, g, test, procs, n):
    """``n`` draws of ``gen_mod.op(g, test, p)`` round-robin over
    ``procs`` on this thread, each op as sorted plain items (None once
    exhausted)."""
    out = []
    for i in range(n):
        o = gen_mod.op(g, test, procs[i % len(procs)])
        if o is None:
            out.append(None)
            continue
        out.append(tuple(sorted(
            (k, ("kv", v.key, v.value)
             if isinstance(v, (TKV.KVTuple, JKV.KVTuple)) else v)
            for k, v in dict(o).items())))
    return out
