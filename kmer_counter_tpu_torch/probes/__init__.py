"""The probe harnesses under docs/, ported: one module per probe script,
with the script's name.

- ``experiments_mosaic_caps``: Q1-Q4 (D4-D7), row rolls, a row gather at
  starts held on the device, and the merge of two sorted 64K halves.
- ``experiments_bitonic_merge``: D2, the merge of two sorted 1024-key
  windows, and D3, the same over a grid of 512 pairs with its throughput.
- ``probe_compact_overhead``: D1's per-tile copy, cumsum and network
  bodies and K2 (``full``), timed in chains as the original times them.

Each module has ``main(device=None)``, cuda by default, and runs as
``python -m kmer_counter_tpu_torch.probes.<name>``; importing one runs
nothing.  A harness prints what the original prints, correctness first,
then time.  Where the original prints FAIL and carries on, the port
raises: a wrong result (``ProbeFailed``) or an exception ends the run with
a non-zero exit code.
"""

from __future__ import annotations

import torch


class ProbeFailed(AssertionError):
    """A probe's result differs from its NumPy check."""


def resolve(device) -> torch.device:
    """The harness's device: cuda unless the caller names another."""
    return torch.device("cuda") if device is None else torch.device(device)


def check(name: str, ok: bool, detail: str = "") -> None:
    if not ok:
        raise ProbeFailed(f"{name}: WRONG VALUES {detail}".rstrip())


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
