#!/usr/bin/env bash
# The port's repo gate: the counterpart of scripts/check.sh over
# comdb2_tpu_torch, on the card by default. Stages: the port's static
# analysis, the txn / shrink / workload-family / MXU smokes, the mesh
# route, the daemon's service, stream, routing, elastic-fleet and
# tracing smokes. Exits non-zero on the first stage that fails.
#
# --json: one {"stage": ..., "ok": true|false, "secs": N} line per
# stage on stdout (stage output goes to stderr), as check.sh does.
# --device cuda|cpu (default cuda): passed to every daemon (--backend)
# and CLI (--device); with cuda and no card the first stage that
# touches the device fails. Nothing falls back to the CPU.
# --only a,b: run only the named stages.
#
# The native-only stages of check.sh (pmux-smoke and the ASan / TSan /
# clang-tidy builds of the shared C++) stay there, and so does
# pack-parity (it diffs the JAX package's legacy packer, which the port
# does not have). The routing and elastic stages build the plain
# ct_pmux they need (cmake, else one g++ line; scripts/torch_fleet.py).
set -euo pipefail

cd "$(dirname "$0")/.."

STAGES="analysis txn-smoke shrink-smoke wl mxu-smoke multichip \
service-smoke stream routing elastic obs"

JSON_MODE=0
DEVICE=cuda
ONLY=""
usage() {
    echo "usage: scripts/check_torch.sh [--json] [--device cuda|cpu]" \
         "[--only stage,...]" >&2
    echo "stages: $STAGES" >&2
}
while [ $# -gt 0 ]; do
    case "$1" in
        --json) JSON_MODE=1 ;;
        --device) DEVICE=${2:-}; shift ;;
        --device=*) DEVICE=${1#--device=} ;;
        --only) ONLY=${2:-}; shift ;;
        --only=*) ONLY=${1#--only=} ;;
        -h|--help) usage; exit 0 ;;
        *) usage; exit 2 ;;
    esac
    shift
done
case "$DEVICE" in
    cuda|cpu) ;;
    *) echo "--device must be cuda or cpu, not '$DEVICE'" >&2; exit 2 ;;
esac
for s in ${ONLY//,/ }; do
    case " $STAGES " in
        *" $s "*) ;;
        *) echo "unknown stage '$s'" >&2; usage; exit 2 ;;
    esac
done

export PYTHONPATH="${PYTHONPATH:+$PYTHONPATH:}$PWD"

CURRENT_STAGE=""
STAGE_START=$SECONDS

json_line() {
    printf '{"stage": "%s", "ok": %s, "secs": %s}\n' "$1" "$2" "$3"
}

stage_end_ok() {
    if [ -n "$CURRENT_STAGE" ] && [ "$JSON_MODE" = 1 ]; then
        json_line "$CURRENT_STAGE" true $((SECONDS - STAGE_START))
    fi
    CURRENT_STAGE=""
}

stage() {            # stage <id> <human banner...>
    stage_end_ok
    CURRENT_STAGE="$1"
    STAGE_START=$SECONDS
    shift
    if [ "$JSON_MODE" = 0 ]; then
        echo "== $* =="
    fi
}

on_exit() {
    rc=$?
    if [ "$rc" -ne 0 ] && [ -n "$CURRENT_STAGE" ] \
            && [ "$JSON_MODE" = 1 ]; then
        json_line "$CURRENT_STAGE" false $((SECONDS - STAGE_START))
    fi
}
trap on_exit EXIT

run() {
    if [ "$JSON_MODE" = 1 ]; then
        "$@" 1>&2
    else
        "$@"
    fi
}

selected() {
    [ -z "$ONLY" ] || case ",$ONLY," in *",$1,"*) return 0 ;; *) return 1 ;; esac
}

gate() {             # gate <stage>: the stage's body in torch_gate.py
    run python scripts/torch_gate.py "$1" --device "$DEVICE"
}

if selected analysis; then
    stage analysis "the port's static analysis"
    run python -m comdb2_tpu_torch.analysis
fi

if selected txn-smoke; then
    stage txn-smoke "txn serializability checker smoke (host engine)"
    gate txn-smoke
fi

if selected shrink-smoke; then
    stage shrink-smoke "shrink smoke (seeded stale-read fixture)"
    gate shrink-smoke
fi

if selected wl; then
    stage wl "workload-family checkers smoke (bank/sets/dirty)"
    gate wl
fi

if selected mxu-smoke; then
    stage mxu-smoke "MXU frontier engine smoke (wide-P valid + violation)"
    gate mxu-smoke
fi

if selected multichip; then
    stage multichip "the mesh route (8 CPU slots, or the one card)"
    gate multichip
fi

if selected service-smoke; then
    stage service-smoke "verifier service smoke"
    gate service-smoke
fi

if selected stream; then
    stage stream "streaming verification sessions smoke (kind:\"stream\")"
    gate stream
fi

if selected routing; then
    stage routing "pmux-routed two-daemon fleet smoke"
    gate routing
fi

if selected elastic; then
    stage elastic "elastic fleet smoke (supervisor, SIGKILL nemesis, join, migration)"
    gate elastic
fi

if selected obs; then
    stage obs "tracing + metrics plane smoke (daemon --trace --store)"
    gate obs
fi

stage_end_ok
if [ "$JSON_MODE" = 0 ]; then
    echo "OK: the port's gate passed on --device $DEVICE"
fi
