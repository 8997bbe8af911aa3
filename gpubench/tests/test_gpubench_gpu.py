"""The harness on the card at a tiny size: a traced run reads every
per-layer metric, its shares of a roofline below 100%, and the control
and each planted fault come out not correct.  Skips without a card:

    python3 -m pytest -m gpu gpubench/tests/test_gpubench_gpu.py
"""

import contextlib

import pytest
import torch

from gpubench import cells, harness
from gpubench.controls import faults
from gpubench.tests._tiny import tiny_checkout


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return None  # harness.run's device None is the card


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["tiny.mini", "tiny1.mini"])
def test_a_traced_run_on_the_card_reads_every_layer(root, tmp_path, workload):
    device = card()
    cell = cells.resolve(workload, root)
    r = harness.run(cell, 11, 1.0, True, device, cache_dir=str(tmp_path), log=lambda _: None)
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert {m["name"] for m in cell.per_layer} - {
        "feed.stage_ms", "two_level.consolidate_ms", "one_level.consolidate_ms"} <= set(r["metrics"])
    for name, m in r["metrics"].items():
        if name.endswith("roofline_pct"):
            assert 0 < m["value"] <= 100, (name, m)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", [None, *faults.FAULTS])
def test_the_control_and_each_fault_on_the_card(root, tmp_path, fault):
    device = card()
    cell = cells.resolve("tiny.mini", root)
    flags = faults.control_flags(cell) if fault is None else None
    with faults.planted(fault) if fault else contextlib.nullcontext():
        r = harness.run(cell, 12, 0.5, False, device, cache_dir=str(tmp_path), log=lambda _: None,
                        program_flags=flags)
    assert r["correct"] is False and r["checks"]["records_wrong"]["value"] > 0

