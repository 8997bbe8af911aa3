"""The harness on the card at a tiny size: a traced run reads every
per-layer metric, its shares of a roofline below 100%, the program's
``kmer.*`` spans carry device time, and the control and each planted
fault come out not correct.  Skips without a card:

    python3 -m pytest -m gpu gpubench/tests/test_gpubench_gpu.py
"""

import contextlib

import pytest
import torch

from gpubench import cells, harness
from gpubench import trace as tr
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
@pytest.mark.parametrize("workload", ["tiny.mini", "tiny1.mini", "tiny55f.mini"])
def test_a_traced_run_on_the_card_reads_every_layer(root, tmp_path, workload, monkeypatch):
    device = card()
    cell = cells.resolve(workload, root)
    seen = []
    traced = tr.traced

    def keep_events(*args, **kwargs):
        out = traced(*args, **kwargs)
        seen.append(out[1])
        return out

    monkeypatch.setattr(tr, "traced", keep_events)
    r = harness.run(cell, 11, 1.0, True, device, cache_dir=str(tmp_path), log=lambda _: None)
    assert r["device"]["platform"] == "gpu" and 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert {m["name"] for m in cell.per_layer} - {
        "feed.stage_ms", "two_level.consolidate_ms", "one_level.consolidate_ms"} <= set(r["metrics"])
    for name, m in r["metrics"].items():
        if name.endswith("roofline_pct"):
            assert 0 < m["value"] <= 100, (name, m)
    # The program's spans are in the trace the readers see, each with the
    # device time of what it launched; the program's consolidate span
    # leaves out the prefix's growth that the harness's covers.
    events, = seen
    device_us = {name: tr.layer_device_us(events, name)[0]
                 for name in ("kmer.consolidate", "kmer.finalize", "kmer.dump", "consolidate")}
    assert all(device_us[name] > 0 for name in ("kmer.consolidate", "kmer.finalize", "kmer.dump")), device_us
    assert device_us["kmer.consolidate"] <= device_us["consolidate"], device_us
    assert r["correct"] is True, r["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["tiny.mini", "tiny55f.mini"])
@pytest.mark.parametrize("fault", [None, *faults.FAULTS])
def test_the_control_and_each_fault_on_the_card(root, tmp_path, workload, fault):
    device = card()
    cell = cells.resolve(workload, root)
    flags = faults.control_flags(cell) if fault is None else None
    with faults.planted(fault) if fault else contextlib.nullcontext():
        r = harness.run(cell, 12, 0.5, False, device, cache_dir=str(tmp_path), log=lambda _: None,
                        program_flags=flags)
    assert r["correct"] is False and r["checks"]["records_wrong"]["value"] > 0, r["checks"]
