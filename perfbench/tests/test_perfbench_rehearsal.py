"""The harness end to end on the CPU at a tiny size (the port's plain
kernel versions): a well-formed last line, the check passing on the port
and failing on each fault a one-chip serving cell can have, and nothing of
JAX loaded. ``run.py`` itself refuses to run without a card."""

import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.faults import FAULTS
from perfbench.tests.tiny import CELLS, tiny_cell

ROOT = Path(__file__).resolve().parents[2]


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CT_TORCH_", "JAX"))}
    return dict(env, CUDA_VISIBLE_DEVICES="")


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_entry_prints_a_well_formed_line(cell):
    p = subprocess.run([sys.executable, "perfbench/tests/cpu_run.py", cell,
                        str(2**31 + 11), "1.5"], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    assert line["device"]["count"] == 0
    assert "busy_s" not in line["device"] and "breakdown" not in line
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    sources = {m["name"]: m["source"] for m in bench["end_to_end"]
               + bench["per_layer"]}
    assert all(sources[m] == "program_counter" for m in line["metrics"])
    # the compared numbers, each beside its limit, end standard error
    tail = p.stderr.strip().splitlines()[-len(line["check"]):]
    for (key, c), text in zip(line["check"].items(), tail):
        assert text == f"{key} {c['value']} limit {c['limit']}"
    assert line["check"]["jax_modules"]["value"] == 0


def test_run_refuses_without_a_card():
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""


def test_run_refuses_the_ports_flags():
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=dict(_env(), CT_TORCH_W4_ACT="bf16"),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_nothing_of_jax_loaded_after_a_run():
    code = ("import sys; sys.argv = ['x', 'qwen2.5-7b.chat', '3', '1'];"
            "sys.path.insert(0, 'perfbench/tests');"
            "import cpu_run; rc = cpu_run.main(sys.argv[1:]);"
            "top = {m.split('.')[0] for m in sys.modules};"
            "print('LOADED', sorted(top & {'jax', 'jaxlib', 'flax', "
            "'compressed_tensors_tpu'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "LOADED []" in p.stdout


def test_forbidden_names_compare_whole(monkeypatch):
    """The port's name begins with the JAX package's; only whole top-level
    names count."""
    monkeypatch.setitem(sys.modules, "compressed_tensors_tpu_torch.x",
                        types.ModuleType("compressed_tensors_tpu_torch.x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "compressed_tensors_tpu.models",
                        types.ModuleType("compressed_tensors_tpu.models"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["compressed_tensors_tpu",
                                           "jaxlib"]


# ---- faults planted underneath the timed path ------------------------- #

@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_faults_fail_the_check(cell, fault):
    res = harness.run_cell(cell, 5, 3.0, False, "cpu", time.perf_counter(),
                           cell=tiny_cell(cell), hooks=FAULTS[fault])
    assert res["correct"] is False, res["_info"]
    assert res["check"]["missing"]["value"] == 0, res["_info"]
    assert res["check"]["widest_gap_sd"]["value"] > \
        res["check"]["widest_gap_sd"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_passes_in_process(cell):
    res = harness.run_cell(cell, 6, 1.5, False, "cpu", time.perf_counter(),
                           cell=tiny_cell(cell))
    assert res["correct"] is True
    assert torch.get_default_dtype() == torch.float32
