"""CLI entry point — the same flags and modes as ``python -m kmer_counter_tpu``.

Count mode:
    python -m kmer_counter_tpu_torch kmerLength=31 inputFileLocation=DIR \\
        outputFile=out.bin [gpuMemoryLimit=N] [canonical=true] ...

Print mode:
    python -m kmer_counter_tpu_torch print <input.bin> <output|-> <kmerLength>

Counting runs on the CUDA device; without one it fails.
"""

from __future__ import annotations

import sys

import torch

from kmer_counter_tpu_torch.config import Options


def main(argv: list[str] | None = None, device: torch.device | None = None) -> int:
    """Run the CLI; ``device`` None means ``torch.device("cuda")``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    print("### kmer-counter-tpu ###")

    if len(argv) == 4 and argv[0] == "print":
        from kmer_counter_tpu_torch.io.printer import print_records

        _, input_path, output_path, k = argv
        try:
            k_int = int(k)
            if output_path not in ("-", ""):
                with open(output_path, "w") as fh:
                    print_records(input_path, k_int, out=fh)
            else:
                print_records(input_path, k_int)
        except FileNotFoundError:
            print(f"error: no such record file: {input_path}", file=sys.stderr)
            return 2
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        return 0

    opts = Options.from_argv(argv)
    for flag, (attr, _) in Options._FLAGS.items():
        if any(a.startswith(flag + "=") for a in argv):
            print(f"Updating {flag}={getattr(opts, attr)}")
    missing = [
        name
        for name, value in (
            ("inputFileLocation", opts.input_dir),
            ("outputFile", opts.output_file),
        )
        if not value
    ]
    if missing:
        print(f"error: required flag(s) not set: {', '.join(missing)}", file=sys.stderr)
        return 2

    from kmer_counter_tpu_torch.engine import run_count

    run_count(opts, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
