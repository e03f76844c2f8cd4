"""The port's repo gate, ``scripts/check_torch.sh``, on CPU: its stage
list against the JAX package's ``scripts/check.sh``, a run of three of
its stages at ``--device cpu``, its refusal of ``--device cuda`` on a
host without a card (no fallback), and the elastic-fleet scenario of
``scripts/torch_elastic.py`` at one request per size class with the
daemons on the CPU."""
from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = os.path.join(REPO, "scripts", "check_torch.sh")
#: check.sh's stages the port's gate leaves to it: the native-only
#: stages over the shared C++, and the JAX package's legacy-packer diff
NOT_PORTED = {"asan-build", "native-static-analysis", "pmux-smoke", "tsan",
              "pack-parity"}


def _stages(path):
    with open(path) as fh:
        return re.findall(r"^\s*stage ([\w-]+) ", fh.read(), re.M)


def _gate(*args, env=None, timeout=600):
    return subprocess.run(["bash", GATE, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def _json_lines(stdout):
    return [json.loads(ln) for ln in stdout.splitlines() if ln.strip()]


def _no_card_env():
    return dict(os.environ, CUDA_VISIBLE_DEVICES="")


def test_stage_list_is_check_sh_minus_the_native_stages():
    ref = _stages(os.path.join(REPO, "scripts", "check.sh"))
    port = _stages(GATE)
    assert port == [s for s in ref if s not in NOT_PORTED]
    assert NOT_PORTED <= set(ref)
    with open(GATE) as fh:
        listed = re.search(r'^STAGES="([^"]+)"', fh.read(), re.M).group(1)
    assert listed.replace("\\\n", " ").split() == port


def test_three_stages_pass_on_cpu_with_one_json_line_each():
    r = _gate("--only", "txn-smoke,shrink-smoke,mxu-smoke", "--device",
              "cpu", "--json")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = _json_lines(r.stdout)
    assert [ln["stage"] for ln in lines] == ["txn-smoke", "shrink-smoke",
                                            "mxu-smoke"]
    assert all(ln["ok"] is True and ln["secs"] >= 0 for ln in lines)
    assert "engine=mxu-frontier" in r.stderr


def test_cuda_without_a_card_fails_at_the_first_device_stage():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _gate("--only", "shrink-smoke,wl", "--json", env=_no_card_env())
    assert r.returncode != 0
    lines = _json_lines(r.stdout)
    assert lines == [{"stage": "shrink-smoke", "ok": False,
                      "secs": lines[0]["secs"]}]
    assert "CUDA is not available" in r.stderr


@pytest.mark.parametrize("args", [["--only", "asan-build"],
                                  ["--device", "tpu"], ["--bogus"]])
def test_bad_arguments_exit_2_before_any_stage(args):
    r = _gate(*args, "--json")
    assert r.returncode == 2 and r.stdout == ""


@pytest.mark.parametrize("stage", ["mxu-smoke", "service-smoke",
                                   "elastic"])
def test_a_device_stage_refuses_cuda_without_a_card(stage):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, os.path.join(
        REPO, "scripts", "torch_gate.py"), stage], cwd=REPO,
        capture_output=True, text=True, timeout=300, env=_no_card_env())
    assert r.returncode == 1
    assert "CUDA is not available" in r.stderr


def test_elastic_gate_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, os.path.join(
        REPO, "scripts", "torch_elastic.py"), "--quick", "--log-dir",
        str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=_no_card_env())
    assert r.returncode == 2
    assert "CUDA is not available" in r.stderr
    assert r.stdout == "" and os.listdir(tmp_path) == []


def test_elastic_scenario_on_cpu(tmp_path):
    """The three scenarios at one request per size class, the daemons
    on the CPU: every request answered once, the fleet history VALID,
    the join's remap about 1/3 and all onto the newcomer, the session
    moved once with 0 replays on the kernel rung, nothing left behind."""
    spec = importlib.util.spec_from_file_location(
        "torch_elastic", os.path.join(REPO, "scripts", "torch_elastic.py"))
    el = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(el)
    out = el.run("cpu", 1, log_dir=str(tmp_path))
    assert out["gate_ok"], out
    assert out["kill"]["deaths_reaped"] == 1
    assert out["kill"]["victim_exit"] == -9
    assert out["kill"]["stale_cleanups"] == 1
    assert out["kill"]["survivor_served_after_kill"] > 0
    assert 0.15 < out["join"]["remapped_fraction"] < 0.5
    assert out["join"]["moved_only_to_newcomer"]
    assert out["stream"]["migrations"] == 1
    assert out["stream"]["replays_after_handoff"] == 0
    assert out["stream"]["engine_before"] == "kernel" == \
        out["stream"]["engine_after"]
    sc = out["self_check"]
    assert sc["answered_exactly_once"] and sc["fleet_history_valid"] is True
    assert sc["fleet_history_ops"] == 2 * sc["requests"]
    assert out["leftovers"]["zombies"] == [] == out["leftovers"]["alive"]
    # one stderr file per spawn: two, the respawn, the join, and a
    # respawn of the drained daemon when it exits inside the refill loop
    n = out["supervisor"]["spawned"]
    assert n in (4, 5)
    assert sorted(os.listdir(tmp_path)) == [f"daemon-{i}.err"
                                            for i in range(n)]
