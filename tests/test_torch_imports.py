"""The torch port imports neither JAX nor anything of the JAX package, and
asking it for CUDA without a GPU fails loudly instead of running on the
CPU."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from kmer_counter_tpu_torch.config import Options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "kmer_counter_tpu_torch",
    "kmer_counter_tpu_torch.__main__",
    "kmer_counter_tpu_torch.budget",
    "kmer_counter_tpu_torch.checkpoint",
    "kmer_counter_tpu_torch.config",
    "kmer_counter_tpu_torch.cuda_build",
    "kmer_counter_tpu_torch.engine",
    "kmer_counter_tpu_torch.feed",
    "kmer_counter_tpu_torch.io",
    "kmer_counter_tpu_torch.io.dump",
    "kmer_counter_tpu_torch.io.fastq",
    "kmer_counter_tpu_torch.io.native",
    "kmer_counter_tpu_torch.io.printer",
    "kmer_counter_tpu_torch.io.spill",
    "kmer_counter_tpu_torch.metrics",
    "kmer_counter_tpu_torch.ops",
    "kmer_counter_tpu_torch.ops.compact_live",
    "kmer_counter_tpu_torch.ops.encode",
    "kmer_counter_tpu_torch.ops.extract",
    "kmer_counter_tpu_torch.ops.fused_extract",
    "kmer_counter_tpu_torch.ops.lane_sort",
    "kmer_counter_tpu_torch.ops.merge_fold_compact",
    "kmer_counter_tpu_torch.ops.merge_runs",
    "kmer_counter_tpu_torch.ops.pipeline",
    "kmer_counter_tpu_torch.ops.probes",
    "kmer_counter_tpu_torch.ops.record_pack",
    "kmer_counter_tpu_torch.ops.sortcount",
    "kmer_counter_tpu_torch.ops.table",
    "kmer_counter_tpu_torch.ops.table2",
    "kmer_counter_tpu_torch.ops.u32",
    "kmer_counter_tpu_torch.parallel",
    "kmer_counter_tpu_torch.parallel.mesh",
    "kmer_counter_tpu_torch.parallel.pipeline",
    "kmer_counter_tpu_torch.parallel.shuffle",
    "kmer_counter_tpu_torch.probes",
    "kmer_counter_tpu_torch.probes.experiments_bitonic_merge",
    "kmer_counter_tpu_torch.probes.experiments_mosaic_caps",
    "kmer_counter_tpu_torch.probes.probe_compact_overhead",
    "kmer_counter_tpu_torch.records",
]


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = REPO
    return env


def test_port_lists_every_module():
    pkg = os.path.join(REPO, "kmer_counter_tpu_torch")
    found = set()
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                found.add(rel.removesuffix(".__init__"))
    assert found == set(PORT_MODULES)


def test_port_imports_no_jax():
    # A subprocess: this test process already imported jax (conftest) and
    # the JAX package.
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'kmer_counter_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=_clean_env(),
        cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_engine_refuses_cuda_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    from kmer_counter_tpu_torch.engine import CountEngine

    opts = Options(kmer_length=15, input_dir=str(tmp_path), output_file=str(tmp_path / "o.bin"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CountEngine(opts, device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CountEngine(opts)  # the default device is cuda


def test_cli_count_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "a.fastq").write_text("@r\nACGTACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIIIIIII\n")
    out = tmp_path / "o.bin"
    proc = subprocess.run(
        [sys.executable, "-m", "kmer_counter_tpu_torch", "kmerLength=9",
         f"inputFileLocation={tmp_path / 'in'}", f"outputFile={out}", "verbose=0"],
        capture_output=True, text=True, env=_clean_env(), cwd=REPO, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not out.exists()


@pytest.mark.parametrize(
    "kw,what",
    [
        ({"mesh_shape": (2,)}, "mesh"),
        ({"checkpoint_dir": "ck"}, None),
        ({"profile": True}, None),
    ],
    ids=["kw0-mesh", "kw1-checkpoint", "kw2-profile"],
)
def test_unported_options_raise(tmp_path, kw, what):
    """Nothing the JAX package has raises any more: checkpointDir and
    profile=true build the engine, and meshShape makes run_count take the
    mesh engine (a one-position mesh on the CPU, as meshShape=2 on one
    card)."""
    from kmer_counter_tpu_torch import engine

    opts = Options(kmer_length=15, input_dir=str(tmp_path), output_file=str(tmp_path / "o"), **kw)
    cpu = torch.device("cpu")
    assert engine._mesh_wanted(opts, cpu) == (what == "mesh")
    built = (engine.MeshCountEngine if what else engine.CountEngine)(opts, device=cpu)
    assert built.opts is opts
    if what:
        assert built.mesh.size == 1 and built.mesh.world == 1


def test_several_ranks_raise(tmp_path, monkeypatch):
    """WORLD_SIZE > 1 takes the mesh engine, which joins torchrun's process
    group: without a rendezvous address that raises, rather than counting
    one rank's files alone."""
    from kmer_counter_tpu_torch import engine

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    opts = Options(kmer_length=15, input_dir=str(tmp_path), output_file=str(tmp_path / "o"))
    assert engine._mesh_wanted(opts, torch.device("cpu"))
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        engine.run_count(opts, torch.device("cpu"))


def test_kernel_wrapper_has_no_fallback_for_other_devices():
    from kmer_counter_tpu_torch.ops.merge_fold_compact import merge_fold_compact

    ops = [torch.zeros(4, dtype=torch.int32, device="meta") for _ in range(2)]
    with pytest.raises(RuntimeError, match="no kernel"):
        merge_fold_compact(ops, ops, 1)


def test_sort_wrapper_has_no_fallback_for_other_devices():
    from kmer_counter_tpu_torch.ops.lane_sort import sort_ops

    keys = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        sort_ops(keys, keys[0].clone())


def _imported_packages(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_port_source_names_the_jax_package_in_an_import():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "kmer_counter_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        assert not _imported_packages(path) & {"jax", "kmer_counter_tpu"}, path


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          env=_clean_env(), cwd=REPO, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    env = {k: v for k, v in _clean_env().items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
