"""The command end to end on the CPU (``--dry-run``: a tiny frame, four
cameras a loop): its last line, whole loops, the work it prints, and no
module of JAX or the JAX package in its process; the card-only run."""

import json
import subprocess
import sys
from pathlib import Path
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(workload, seed, extra=()):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", "0", "--trace", "0", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    return out


@pytest.mark.parametrize("workload", ["horizon.flythrough-1080p",
                                      "map.flythrough-1080p",
                                      "horizon.ground-1080p"])
def test_dry_run_line_whole_loops_and_steady_work(workload):
    lines = []
    for seed in (3, 2 ** 31 + 99):
        out = _run(workload, seed, ["--dry-run"])
        assert out.returncode == 0, out.stderr[-3000:]
        lines.append([json.loads(x) for x in out.stdout.strip().splitlines()])
    for info, result in lines:
        assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
        assert result["correct"] is True and result["failed"] == 0
        assert result["attempted"] % 4 == 0 and result["attempted"] > 0
        assert info["loops"] * 4 == result["attempted"]
        assert set(result["metrics"]) == {
            m["name"] for m in SPEC["end_to_end"]
            if workload in m.get("workloads", [workload])}
        for c in result["checks"].values():
            assert c["value"] <= c["limit"]
        work = info["loop_work"]
        assert work["program_work_items"] == [work["work_items"]] * \
            info["loops"]
    assert lines[0][0]["loop_work"] == lines[1][0]["loop_work"]


def test_nothing_of_jax_is_loaded():
    code = ("import sys; sys.path.insert(0, '.'); "
            "from portbench import run; "
            "rc = run.main(['--workload', 'horizon.flythrough-1080p', "
            "'--seed', '5', '--seconds', '0', '--trace', '0', "
            "'--dry-run']); print(run.forbidden_modules(), rc)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.stdout.strip().splitlines()[-1] == "[] 0", out.stderr[-2000:]


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run("horizon.flythrough-1080p", 1)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = _run("horizon.flythrough-1080p", 11, ["--seconds", "1"])
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
