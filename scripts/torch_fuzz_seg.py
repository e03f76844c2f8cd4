#!/usr/bin/env python3
"""Fuzz of the port's segment-search kernel against the seg2 engine.

Usage: python3 scripts/torch_fuzz_seg.py [n] [--device cuda|cpu]
           [--out FUZZ.json]

Runs n seeded random histories PER MODEL FAMILY (register, mutex,
unordered queue, multi-register: valid and corrupted, with process
retirement through :info ops) through the hand-written kernel
(``checker.seg_kernel.check_device_seg_kernel``; on CPU tensors its plain
version) and through ``torch-seg2`` (``checker.linear_torch.
check_device_seg2``), and asserts identical verdicts and fail indices,
and — for VALID runs — identical final frontier counts. On UNKNOWN only
the verdict and the fail segment are compared: the frontier count after
an overflow is a truncation diagnostic and legitimately differs.

Three more stages: the kernel on slot-RENAMED segments
(``remap_slots``, with the driver's ``kernel_slots`` spec choice) must
reproduce the raw-segment verdict; every UNKNOWN is re-checked by seg2
at F = 1024, where it must resolve; and histories sharing a table run
together through the kernel's stream mode (``stream_dispatch``), each
verdict equal to its single-history one. Any mismatch raises.

The families, seeds (500..500+n), bucket ladder and coverage floors are
those of the JAX package's fuzz script. ``--device`` defaults to
``cuda`` (no fallback: without a card the script raises); ``--out``
writes a JSON artifact of the per-family counts.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import random
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _register_case(rng):
    from comdb2_tpu_torch.models import model as M
    from comdb2_tpu_torch.ops.synth import mutate, register_history

    h = register_history(rng, n_procs=rng.randint(2, 5),
                         n_events=rng.randint(10, 60),
                         values=3, p_info=0.05)
    if rng.random() < 0.5:
        h = mutate(rng, h)
    return M.cas_register(), h


def _mutex_history(rng, n_procs, n_events):
    """Concurrent acquire/release attempts against a real lock."""
    from comdb2_tpu_torch.ops.op import fail, invoke, ok

    locked_by = None
    procs = {i: None for i in range(n_procs)}
    h = []
    while len(h) < n_events:
        p = rng.randrange(n_procs)
        if procs[p] is None:
            f = rng.choice(["acquire", "release"])
            procs[p] = f
            h.append(invoke(p, f, None))
        else:
            f = procs[p]
            procs[p] = None
            if f == "acquire":
                if locked_by is None:
                    locked_by = p
                    h.append(ok(p, f, None))
                else:
                    h.append(fail(p, f, None))
            elif locked_by == p:
                locked_by = None
                h.append(ok(p, f, None))
            else:
                h.append(fail(p, f, None))
    return h


def _multireg_history(rng, n_procs, n_events):
    """Micro-transactions of reads and writes over two registers."""
    from comdb2_tpu_torch.ops.op import invoke, ok

    state = {}
    procs = {i: None for i in range(n_procs)}
    h = []
    keys = ["x", "y"]
    while len(h) < n_events:
        p = rng.randrange(n_procs)
        if procs[p] is None:
            micro = []
            for _ in range(rng.randint(1, 2)):
                k = rng.choice(keys)
                if rng.random() < 0.5:
                    micro.append(("write", k, rng.randrange(3)))
                else:
                    micro.append(("read", k, None))
            procs[p] = micro
            h.append(invoke(p, "txn", tuple(tuple(m) for m in micro)))
        else:
            micro = procs[p]
            procs[p] = None
            filled = []
            for mf, k, v in micro:
                if mf == "write":
                    state[k] = v
                    filled.append(("write", k, v))
                else:
                    filled.append(("read", k, state.get(k)))
            h.append(ok(p, "txn", tuple(filled)))
    return h


def _bounded_queue_history(rng, n_procs, n_events):
    """Valid unordered-queue execution over the alphabet {0, 1}: its
    multiset state space fits the kernel's table (a queue of globally
    unique values outgrows every bucket)."""
    from comdb2_tpu_torch.ops.op import Op

    def op(p, t, f, v):
        return Op(process=p, type=t, f=f, value=v, time=0)

    q = collections.deque()
    procs = {i: None for i in range(n_procs)}
    h = []
    while len(h) < n_events:
        p = rng.randrange(n_procs)
        if procs[p] is None:
            if rng.random() < 0.5:
                v = rng.randrange(2)
                procs[p] = ("enqueue", v)
                h.append(op(p, "invoke", "enqueue", v))
            else:
                procs[p] = ("dequeue", None)
                h.append(op(p, "invoke", "dequeue", None))
        else:
            f, v = procs[p]
            procs[p] = None
            if f == "enqueue":
                q.append(v)
                h.append(op(p, "ok", f, v))
            elif q:
                got = q.popleft() if rng.random() < 0.5 else q.pop()
                h.append(op(p, "ok", f, got))
            else:
                h.append(op(p, "fail", f, None))
    return h


def _corrupt(rng, h):
    """Model-agnostic corruption: flip a fail -> ok, else falsify an ok
    value."""
    h = list(h)
    fails = [i for i, o in enumerate(h) if o.type == "fail"]
    oks = [i for i, o in enumerate(h)
           if o.type == "ok" and o.value is not None]
    if fails:
        i = rng.choice(fails)
        h[i] = h[i].with_(type="ok")
    elif oks:
        i = rng.choice(oks)
        v = h[i].value
        if isinstance(v, tuple) and v and isinstance(v[0], tuple):
            mf, k, mv = v[0]
            h[i] = h[i].with_(value=((mf, k, (mv or 0) + 7),) + v[1:])
        else:
            h[i] = h[i].with_(value=999)
    return h


def families():
    """``(name, case_fn)`` per model family, in the JAX package's
    order; ``case_fn(rng)`` returns ``(model, history)``."""
    from comdb2_tpu_torch.models import model as M

    def mk(mk_model, mk_hist):
        def case(rng):
            h = mk_hist(rng, rng.randint(2, 4), rng.randint(10, 50))
            if rng.random() < 0.4:
                h = _corrupt(rng, h)
            return mk_model(), h
        return case

    def bounded_queue_case(rng):
        h = _bounded_queue_history(rng, rng.randint(2, 4),
                                   rng.randint(10, 16))
        if rng.random() < 0.4:
            h = _corrupt(rng, h)
        return M.unordered_queue(), h

    return [("register", _register_case),
            ("mutex", mk(M.mutex, _mutex_history)),
            ("unordered-queue", bounded_queue_case),
            ("multi-register", mk(M.multi_register, _multireg_history))]


def _bucket_of(mm):
    """The declared bucket a memo's table fits, or None."""
    if mm.n_states <= 8 and mm.n_transitions <= 32:
        bucket = (8, 32)
    elif mm.n_states <= 16 and mm.n_transitions <= 64:
        bucket = (16, 64)
    elif mm.n_states <= 64 and mm.n_transitions <= 64:
        bucket = (64, 64)
    elif mm.n_states <= 128 and mm.n_transitions <= 64:
        bucket = (128, 64)
    elif mm.n_states <= 256 and mm.n_transitions <= 8:
        # tall-narrow tier: queue memos grow states far faster than
        # transitions
        bucket = (256, 8)
    else:
        return None
    return bucket


def _cross_check(name, seed, case, dev, c):
    """One seeded case through the kernel, seg2, the renamed-slots
    stage and (for an UNKNOWN) seg2 at F = 1024; counts into ``c`` and
    returns ``(bucket, P, succ, segs, verdict)`` for the stream stage,
    or None when the case does not fit the kernel."""
    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.checker import seg_kernel as SK
    from comdb2_tpu_torch.checker.linear import kernel_slots
    from comdb2_tpu_torch.models.memo import MemoOverflow
    from comdb2_tpu_torch.models.memo import memo as make_memo
    from comdb2_tpu_torch.ops.packed import pack_history

    rng = random.Random(seed)
    model, h = case(rng)
    packed = pack_history(h)
    try:
        mm = make_memo(model, packed)
    except MemoOverflow:
        c[name, "memo-skip"] += 1
        return None
    P = len(packed.process_table)
    segs = LT.make_segments(packed, s_pad=64, k_pad=8)
    bucket = _bucket_of(mm)
    if bucket is None or P > 15 or segs.inv_proc.shape != (64, 8):
        c[name, "skip"] += 1
        return None
    ns, nt = bucket
    succ = LT.pad_succ(mm.succ, ns, nt)
    r = SK.check_device_seg_kernel(succ, segs, n_states=ns,
                                   n_transitions=nt, P=P, device=dev)
    if r is None:
        c[name, "nofit"] += 1
        return None
    st, fa, n_f = r
    args = (succ, segs.inv_proc, segs.inv_tr, segs.ok_proc, segs.depth)
    st2, fa2, n2 = (int(x) for x in LT.check_device_seg2(
        *args, F=128, P=P, n_states=ns, n_transitions=nt, device=dev))
    if st != st2 or (st != 0 and fa != fa2) or (st == 0 and n_f != n2):
        raise AssertionError(f"{name} seed={seed}: kernel {r} seg2 "
                             f"{(st2, fa2, n2)}")
    c[name, "ok" if st == 0 else ("inv" if st == 1 else "unk")] += 1
    # renamed slots: the kernel on REMAPPED segments at the driver's
    # spec choice reproduces the raw-segment verdict
    segs_r, p_eff = LT.remap_slots(segs)
    P_r = kernel_slots(p_eff)
    if P_r <= 15:
        rr = SK.check_device_seg_kernel(succ, segs_r, n_states=ns,
                                        n_transitions=nt, P=P_r,
                                        device=dev)
        if rr is not None:
            if rr[0] != st or (st != 0 and rr[1] != fa) \
                    or (st == 0 and rr[2] != n_f):
                raise AssertionError(f"{name} seed={seed} renamed: {rr} "
                                     f"vs {r}")
            c[name, "renamed"] += 1
    if st == 2:
        # an UNKNOWN must resolve at a wider frontier: a kernel fault
        # masquerading as an overflow must not hide
        st3 = int(LT.check_device_seg2(*args, F=1024, P=P, n_states=ns,
                                       n_transitions=nt, device=dev)[0])
        c[name, {0: "unk-resolved-valid", 1: "unk-resolved-invalid",
                 2: "unk-unexplained"}[st3]] += 1
        if st3 == 2:
            raise AssertionError(f"{name} seed={seed}: unknown persists "
                                 "at F=1024")
    return bucket, P, succ, segs, r


def run(n: int, device: str = "cuda") -> dict:
    """The fuzz at ``n`` seeds per family on ``device``; returns the
    artifact (raises on any mismatch or a coverage floor missed)."""
    from comdb2_tpu_torch.checker import seg_kernel as SK
    from comdb2_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    c = Counter()
    cases = families()
    names = [nm for nm, _ in cases]
    stream_groups: dict = {}
    for name, case in cases:
        for seed in range(500, 500 + n):
            got = _cross_check(name, seed, case, dev, c)
            if got is not None:
                bucket, P, succ, segs, r = got
                stream_groups.setdefault((bucket, P), []).append(
                    (succ, segs, r))
        print(name, {k[1]: v for k, v in c.items() if k[0] == name},
              flush=True)
    if not any(c[nm, "ok"] for nm in names) \
            or not any(c[nm, "inv"] for nm in names):
        raise AssertionError(f"no VALID or no INVALID case: {dict(c)}")
    q_checked = sum(c["unordered-queue", k] for k in ("ok", "inv", "unk"))
    if q_checked < (2 * n) // 3:
        raise AssertionError(f"unordered-queue kernel coverage "
                             f"{q_checked}/{n}")

    # stream stage: histories sharing a table in one stream launch
    n_streamed = 0
    for (bucket, P), group in stream_groups.items():
        by_table: dict = {}
        for succ_g, segs, r in group:
            by_table.setdefault(succ_g.tobytes(), []).append((succ_g, segs,
                                                              r))
        for sub in by_table.values():
            if len(sub) < 2:
                continue
            spec = SK.spec_for(bucket[0], bucket[1], P, 8)
            rs = SK.stream_dispatch(sub[0][0], [s for _, s, _ in sub],
                                    spec, bucket[0], bucket[1],
                                    device=dev)
            for b, (_, _, want) in enumerate(sub):
                st, fa, n_f = rs[b]
                if st != want[0] or (st == 1 and fa != want[1]) \
                        or (st == 0 and n_f != want[2]):
                    raise AssertionError(f"stream b={b}: {rs[b]} vs "
                                         f"single {want}")
                n_streamed += 1
    print("stream stage:", n_streamed, "histories cross-checked",
          flush=True)
    # at least a third of n (a small run legitimately forms few groups
    # that share a table: none at 2 seeds per family)
    if n_streamed < n // 3:
        raise AssertionError(f"stream stage covered {n_streamed} "
                             f"histories at {n} seeds per family")
    renamed_by_family = {}
    for nm in names:
        fam_device = sum(c[nm, k] for k in ("ok", "inv", "unk"))
        renamed_by_family[nm] = {"device_checked": fam_device,
                                 "renamed": c[nm, "renamed"]}
        if c[nm, "renamed"] < (2 * fam_device) // 3:
            raise AssertionError(f"{nm}: renamed-slots coverage "
                                 f"{c[nm, 'renamed']}/{fam_device}")
    fams = {}
    for nm in names:
        fam = {k[1]: v for k, v in c.items() if k[0] == nm}
        fam["seeds"] = n
        fams[nm] = fam
    return {
        "seeds_per_family": n,
        "families": fams,
        "total_cross_checked": int(sum(
            c[nm, k] for nm in names for k in ("ok", "inv", "unk"))),
        "renamed_slots_cross_checked": int(sum(c[nm, "renamed"]
                                               for nm in names)),
        "renamed_slots_by_family": renamed_by_family,
        "stream_histories_cross_checked": n_streamed,
        "engines": ["seg-kernel", "torch-seg2", "seg-kernel-stream",
                    "seg-kernel-renamed-slots"],
        "device": (f"{dev.type}: " + __import__("torch").cuda
                   .get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "verdict": "PASS",   # any mismatch raises before this
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", nargs="?", type=int, default=120,
                   help="seeds per model family (default 120)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernel) or cpu (its plain version)")
    p.add_argument("--out", help="write the JSON artifact here")
    args = p.parse_args(argv)
    artifact = run(args.n, args.device)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(artifact, fh, indent=1)
        print("artifact written:", args.out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
