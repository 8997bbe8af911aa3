"""Faults planted in the program under a run, each of which the
comparison has to catch (``correct`` false):

    step_unchanged    every fourth chunk step (the 2nd, the 6th, ...)
                      returns the table unchanged: its reads never counted
    half_batch        every chunk step counts only the first half of its reads
    answer_altered    the first count of the table the finalize hands to
                      the dump is one more than counted

(The exchange between chips does not exist in a one-chip cell.)  And the
control: the program run with ``canonical`` switched, a guarantee of the
configuration broken, against the configuration's reference."""

from __future__ import annotations

import contextlib
import functools
import importlib

FAULTS = ("step_unchanged", "half_batch", "answer_altered")


def control_flags(cell) -> dict:
    """The control's program flags: canonical switched."""
    return {"canonical": not bool(cell.flags.get("canonical", False))}


def _patch(stack, module_name, attr, make):
    module = importlib.import_module(f"kmer_counter_tpu_torch.{module_name}")
    original = getattr(module, attr)
    setattr(module, attr, functools.wraps(original)(make(original)))
    stack.callback(setattr, module, attr, original)


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted, for the block's length."""
    with contextlib.ExitStack() as stack:
        if fault == "step_unchanged":
            calls = [0]

            def unchanged(original):
                def step(table_or_reads, *args, **kwargs):
                    calls[0] += 1
                    if calls[0] % 4 == 2:
                        return table_or_reads
                    return original(table_or_reads, *args, **kwargs)
                return step

            _patch(stack, "ops.pipeline", "count_step_two_level", unchanged)
            _patch(stack, "ops.table", "append", unchanged)
        elif fault == "half_batch":
            def half(original):
                def step(table, reads, *args, **kwargs):
                    return original(table, reads[: max(len(reads) // 2, 1)], *args, **kwargs)
                return step

            def half_extract(original):
                def extract(reads, *args, **kwargs):
                    return original(reads[: max(len(reads) // 2, 1)], *args, **kwargs)
                return extract

            _patch(stack, "ops.pipeline", "count_step_two_level", half)
            _patch(stack, "ops.pipeline", "extract_chunk", half_extract)
        elif fault == "answer_altered":
            def altered(original):
                def dump_table(path, lanes, counts, *args, **kwargs):
                    counts = counts.copy()
                    counts[0] += 1
                    return original(path, lanes, counts, *args, **kwargs)
                return dump_table

            _patch(stack, "engine", "dump_table", altered)
        else:
            raise ValueError(f"unknown fault {fault!r} (have {', '.join(FAULTS)})")
        yield
