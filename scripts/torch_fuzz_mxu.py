#!/usr/bin/env python3
"""Fuzz of the port's MXU frontier engine, the only engine that answers
P >= 16 (``checker/mxu.py``), against the big-only seg engine, the host
oracle and, where its gate admits the shape, the segment-search kernel.

Usage: python3 scripts/torch_fuzz_mxu.py [n] [--device cuda|cpu]
           [--out FUZZ.json]

The counterpart of the JAX package's ``scripts/fuzz_mxu.py``: the same
seeded families at the same seeds and buckets, and its parity rules
and floors.

- ``register``: small random register histories (valid and mutated;
  seeds 3000..3000+n) at F = 128 through ``mxu.check_device_mxu``,
  ``linear_torch.check_device_seg`` and ``linear_host.check``; where
  the kernel serves the shape (P <= 15, K <= 8),
  ``seg_kernel.check_device_seg_kernel`` too (``kernel-crosschecked``).
- ``waves-p16`` / ``waves-p24``: genuinely concurrent bounded-in-flight
  wave histories (``wide_register_batch_columns``, seeds 4000..4000+n)
  at P = 16 and 24, valid and seeded-violation twins, MXU against seg
  at F = 1024 and the host oracle on every seed.

Verdicts and fail segments must agree across engines; final counts
only on VALID, and only between engines at the same F (the kernel's F
is its fixed 128). Floors: two thirds of the register seeds checked,
both verdict classes in every family, every register shape inside the
MXU engine, no UNKNOWN in the wave families. ``--device`` defaults to
``cuda`` (no fallback: without a card the script raises); on CPU
tensors every engine, the kernel included, runs as its plain version.
``--out`` writes a JSON artifact with the per-family counts, the card's
name and every case's verdicts.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

STATUS = {0: "ok", 1: "inv", 2: "unk"}
#: the (n_states, n_transitions) bucket every family pads its table to
BUCKET = (32, 64)
#: the segment-search kernel's frontier capacity
KERNEL_F = 128


def check_all(segs, succ, P, F, dev):
    """``{engine: (status, fail_seg, n)}`` for every engine serving the
    bucketed shape: ``seg`` always, ``mxu`` where it fits, and
    ``seg-kernel`` where the kernel's gate admits it."""
    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.checker import mxu as MXU
    from comdb2_tpu_torch.checker import seg_kernel as SK

    sizes = dict(n_states=BUCKET[0], n_transitions=BUCKET[1])
    args = (succ, segs.inv_proc, segs.inv_tr, segs.ok_proc, segs.depth)
    out = {"seg": tuple(int(x) for x in LT.check_device_seg(
        *args, F=F, P=P, device=dev, **sizes))}
    if MXU.fits(BUCKET[0], BUCKET[1], P):
        out["mxu"] = tuple(int(x) for x in MXU.check_device_mxu(
            *args, F=F, P=P, device=dev, **sizes))
    if P <= 15 and segs.inv_proc.shape[1] <= 8:
        r = SK.check_device_seg_kernel(succ, segs, P=P, device=dev, **sizes)
        if r is not None:
            out["seg-kernel"] = tuple(int(x) for x in r)
    return out


def assert_parity(name, seed, verdicts, F, host_valid, host_index,
                  seg_index):
    """The JAX package's rules: one status across engines; the fail
    segment on INVALID and UNKNOWN; the count on VALID between engines
    at the same F; the host oracle's verdict and op index."""
    base = verdicts["seg"]
    for eng, (st, fa, n) in verdicts.items():
        engine_f = KERNEL_F if eng == "seg-kernel" else F
        assert st == base[0], (name, seed, eng, verdicts)
        if st == 0:
            if engine_f == F:
                assert n == base[2], (name, seed, eng, verdicts)
        else:
            assert fa == base[1], (name, seed, eng, verdicts)
    if host_valid is not None and base[0] != 2:
        assert (base[0] == 0) == host_valid, (name, seed, verdicts)
        if base[0] == 1:
            assert int(seg_index[base[1]]) == host_index, \
                (name, seed, verdicts, host_index)


def register_case(seed):
    """Seed ``seed`` of the register family: ``(packed, memo, segs, P)``
    or a skip reason (``memo-skip``, ``skip``)."""
    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.models.memo import MemoOverflow
    from comdb2_tpu_torch.models.memo import memo as make_memo
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops.packed import pack_history
    from comdb2_tpu_torch.ops.synth import mutate, register_history

    rng = random.Random(seed)
    h = register_history(rng, n_procs=rng.randint(2, 5),
                         n_events=rng.randint(10, 60), values=3,
                         p_info=0.05)
    if rng.random() < 0.5:
        h = mutate(rng, h)
    packed = pack_history(h)
    try:
        mm = make_memo(cas_register(), packed)
    except MemoOverflow:
        return "memo-skip"
    if mm.n_states > BUCKET[0] or mm.n_transitions > BUCKET[1]:
        return "skip"
    segs = LT.make_segments(packed, s_pad=64, k_pad=8)
    segs, p_eff = LT.remap_slots(segs)
    P = max(p_eff, 1)
    if segs.inv_proc.shape != (64, 8) or P > 15:
        return "skip"
    return packed, mm, segs, P


def wave_case(P, seed):
    """Seed ``seed`` of the P-wide wave family: ``(packed, memo, segs,
    violation)`` or ``skip``."""
    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.models.memo import memo as make_memo
    from comdb2_tpu_torch.models.model import cas_register
    from comdb2_tpu_torch.ops import synth_columnar as SC

    rng = random.Random(seed)
    n_free = rng.randint(2, 6)               # host-oracle affordable
    n_chain = P - n_free
    n_waves = rng.randint(1, 3)
    violation = rng.random() < 0.5
    cols = SC.wide_register_batch_columns(
        seed, 1, n_waves, n_chain, n_free, values=max(16, n_chain + 2),
        violation=violation)
    packed = SC.pack_register_columns(cols)[0]
    mm = make_memo(cas_register(), packed)
    if mm.n_states > BUCKET[0] or mm.n_transitions > BUCKET[1]:
        return "skip"
    segs = LT.make_segments(packed, s_pad=128, k_pad=32)
    segs, p_eff = LT.remap_slots(segs)
    assert p_eff == P, (p_eff, P)            # genuinely concurrent
    return packed, mm, segs, violation


#: each family's first seed (seeds run first..first+n)
FIRST_SEED = {"register": 3000, "waves-p16": 4000, "waves-p24": 4000}


def run(n: int, device: str = "cuda", seeds=None) -> dict:
    """The fuzz at ``n`` seeds per family on ``device``; returns the
    artifact (raises on any mismatch or a floor missed). ``seeds``
    (family -> list) runs those seeds of a family instead, its floors
    taken over their number."""
    from comdb2_tpu_torch.checker import linear_host
    from comdb2_tpu_torch.checker import linear_torch as LT
    from comdb2_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    seeds = {fam: list((seeds or {}).get(fam, range(first, first + n)))
             for fam, first in FIRST_SEED.items()}
    c = Counter()
    cases = []
    for seed in seeds["register"]:
        got = register_case(seed)
        if isinstance(got, str):
            c["register", got] += 1
            continue
        packed, mm, segs, P = got
        succ = LT.pad_succ(mm.succ, *BUCKET)
        verdicts = check_all(segs, succ, P, KERNEL_F, dev)
        hr = linear_host.check(mm, packed)
        assert_parity("register", seed, verdicts, KERNEL_F, hr.valid,
                      hr.op_index, segs.seg_index)
        c["register", STATUS[verdicts["seg"][0]]] += 1
        if "seg-kernel" in verdicts:
            c["register", "kernel-crosschecked"] += 1
        if "mxu" not in verdicts:
            c["register", "mxu-nofit"] += 1
        cases.append({"family": "register", "seed": seed, "P": P,
                      "F": KERNEL_F, "verdicts": verdicts,
                      "host_valid": hr.valid})
    print("register", {k[1]: v for k, v in c.items()
                       if k[0] == "register"}, flush=True)
    checked = sum(c["register", k] for k in ("ok", "inv", "unk"))
    n_reg = len(seeds["register"])
    assert checked >= (2 * n_reg) // 3, \
        f"register coverage {checked}/{n_reg}"
    assert c["register", "ok"] and c["register", "inv"], dict(c)
    assert c["register", "mxu-nofit"] == 0, \
        "every register bucket shape must fit the MXU engine"

    for P in (16, 24):
        fam = f"waves-p{P}"
        for seed in seeds[fam]:
            got = wave_case(P, seed)
            if isinstance(got, str):
                c[fam, got] += 1
                continue
            packed, mm, segs, violation = got
            succ = LT.pad_succ(mm.succ, *BUCKET)
            verdicts = check_all(segs, succ, P, 1024, dev)
            assert "mxu" in verdicts, "wave shape must fit the engine"
            hr = linear_host.check(mm, packed)
            assert hr.valid is (not violation), (fam, seed, hr.valid)
            assert_parity(fam, seed, verdicts, 1024, hr.valid, hr.op_index,
                          segs.seg_index)
            c[fam, STATUS[verdicts["mxu"][0]]] += 1
            cases.append({"family": fam, "seed": seed, "P": P, "F": 1024,
                          "verdicts": verdicts, "host_valid": hr.valid})
        print(fam, {k[1]: v for k, v in c.items() if k[0] == fam},
              flush=True)
        assert c[fam, "ok"] and c[fam, "inv"], \
            f"{fam}: both verdict classes must be exercised"
        assert c[fam, "unk"] == 0, \
            f"{fam}: bounded waves must never overflow F=1024"

    families = {}
    for fam in ("register", "waves-p16", "waves-p24"):
        families[fam] = {k[1]: v for k, v in c.items() if k[0] == fam}
        families[fam]["seeds"] = len(seeds[fam])
    import torch

    return {
        "seeds_per_family": n,
        "families": families,
        "engines": ["mxu", "seg", "seg-kernel", "linear-host"],
        "device": (f"cuda: {torch.cuda.get_device_name(dev)}"
                   if dev.type == "cuda" else "cpu"),
        "cases": cases,
        "verdict": "PASS",   # any mismatch asserts before this
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", nargs="?", type=int, default=60,
                   help="seeds per family (default 60)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card) or cpu (the plain versions)")
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
