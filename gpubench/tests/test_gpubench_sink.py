"""The dump sink: a named pipe read by a harness thread; a window of counts
leaves no dump file behind and writes nowhere but the checkout, HOME,
XDG_CACHE_HOME and TMPDIR."""

import json
import os
import subprocess
import sys
import threading

import numpy as np

from gpubench import cells
from gpubench.sink import DumpSink
from gpubench.tests._tiny import tiny_checkout


def write(path, data):
    with open(path, "wb") as fh:
        fh.write(data)


def test_the_first_dump_is_kept_and_later_ones_compared(tmp_path):
    sink = DumpSink(str(tmp_path))
    data = np.random.default_rng(0).integers(0, 256, 3 << 20, dtype=np.uint8).tobytes()
    try:
        sink.start(None)
        write(sink.path, data)
        first = sink.finish()
        assert first["data"] == data and first["nbytes"] == len(data) and first["first_diff"] is None
        sink.start(first["data"])
        write(sink.path, data)
        assert sink.finish()["first_diff"] is None
        changed = bytearray(data)
        changed[2_500_000] ^= 1
        sink.start(first["data"])
        write(sink.path, bytes(changed))
        assert sink.finish()["first_diff"] == 2_500_000
        sink.start(first["data"])
        write(sink.path, data[:-5])
        assert sink.finish()["first_diff"] == len(data) - 5
    finally:
        sink.close()
    assert os.listdir(tmp_path) == []


def test_a_writer_that_never_comes_reads_as_an_empty_dump(tmp_path):
    sink = DumpSink(str(tmp_path))
    sink.start(b"expected")
    r = sink.finish()
    assert r["nbytes"] == 0 and r["first_diff"] == 0
    sink.start(None)
    t = threading.Timer(0.2, write, (sink.path, b"late"))  # a writer that comes while the sink waits
    t.start()
    t.join()
    assert sink.finish()["data"] == b"late"
    sink.close()


AUDIT = r"""
import os, sys, json, torch
roots = json.loads(sys.argv[1])
written = []
def hook(event, args):
    if event == "open" and args[0] is not None and not isinstance(args[0], int):
        mode, flags = args[1], args[2]
        if (mode and any(c in mode for c in "wax+")) or (flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
            written.append(os.path.abspath(os.fsdecode(args[0])))
    elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove", "shutil.rmtree", "os.rmdir"):
        written.append(os.path.abspath(os.fsdecode(args[0])))
sys.addaudithook(hook)
sys.path.insert(0, roots["code"])
from gpubench import cells, harness
cell = cells.resolve("tiny.mini", roots["checkout"])
r = harness.run(cell, 5, 1.5, False, torch.device("cpu"), cache_dir=os.path.join(roots["checkout"], "gpubench", "cache"))
assert r["correct"] and r["attempted"] >= 2, r
print(json.dumps(written))
"""


def test_a_window_writes_no_dump_file_and_nothing_outside_its_places(tmp_path):
    checkout = tiny_checkout(tmp_path / "checkout")
    places = {k: str(tmp_path / k) for k in ("home", "xdg", "tmp")}
    for p in places.values():
        os.makedirs(p)
    env = dict(os.environ, HOME=places["home"], XDG_CACHE_HOME=places["xdg"], TMPDIR=places["tmp"])
    roots = {"code": cells.ROOT, "checkout": checkout}
    p = subprocess.run([sys.executable, "-c", AUDIT, json.dumps(roots)], capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    written = json.loads(p.stdout.strip().splitlines()[-1])
    allowed = [checkout, cells.ROOT, *places.values(), "/dev/"]
    outside = [w for w in written if not any(w == a or w.startswith(a.rstrip("/") + "/") for a in allowed)]
    assert outside == []
    # The dump went through the pipe: nothing in TMPDIR is left, and no
    # file in it was ever opened for writing but the FASTQ input.
    assert os.listdir(places["tmp"]) == []
    in_tmp = {os.path.basename(w) for w in written if w.startswith(places["tmp"] + "/")}
    assert {n for n in in_tmp if not n.startswith("gpubench-")} <= {"dump.fifo", "in"} | {
        f"reads_{i:02d}.fastq" for i in range(3)}
    assert not any(n.endswith(".bin") for n in in_tmp)
