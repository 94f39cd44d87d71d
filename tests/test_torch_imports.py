"""The PyTorch port stands alone: importing it loads neither JAX nor the
reference package, no file of it imports either, and its entry points run
on the card unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|repro)(?:[.\s]|$)",
                     re.MULTILINE)


def _port_modules():
    mods = []
    for dirpath, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f),
                                      os.path.join(ROOT, "src"))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_import_loads_neither_jax_nor_reference():
    mods = _port_modules()
    assert "repro_torch.core.engine_torch" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(
    [os.path.join(d, f) for d, _s, fs in os.walk(PKG) for f in fs
     if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]),
    ids=lambda p: os.path.relpath(p, ROOT))
def test_no_file_imports_jax_or_reference(path):
    with open(path) as f:
        assert not _IMPORT.findall(f.read())


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.core import engine_torch
    from repro_torch.core.online import OnlineAllocator
    from repro_torch.core.simulator import (HETEROGENEOUS_AGENTS, PI, WC,
                                            SimConfig, SparkMesosSim)

    with pytest.raises(RuntimeError, match="CUDA"):
        OnlineAllocator(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        SparkMesosSim(HETEROGENEOUS_AGENTS, {"Pi": PI, "WordCount": WC},
                      SimConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_torch.run_epoch(
            "drf", "pooled", X=np.zeros((1, 1)), D=np.ones((1, 2)),
            C=np.ones((1, 2)), FREE=np.ones((1, 2)), phi=np.ones(1),
            allowed=np.ones((1, 1), bool), wanted=np.ones(1),
            true_demands=np.ones((1, 2)))


def test_pergrant_backend_names_the_queued_kernel():
    from repro_torch.core.online import OnlineAllocator

    al = OnlineAllocator(2, criterion="rpsdsf", server_policy="pooled",
                         device="cpu")
    al.add_agent("a0", (4.0, 4.0))
    al.register("f0", demand=(1.0, 1.0), wanted_tasks=2)
    with pytest.raises(NotImplementedError, match="psdsf_argmin"):
        al.allocate_batched(use_kernel="pergrant")


def test_unknown_epoch_kernel_refused():
    from repro_torch.core import engine_torch

    with pytest.raises(ValueError, match="epoch kernel"):
        engine_torch.run_epoch(
            "drf", "pooled", X=np.zeros((1, 1)), D=np.ones((1, 2)),
            C=np.ones((1, 2)), FREE=np.ones((1, 2)), phi=np.ones(1),
            allowed=np.ones((1, 1), bool), wanted=np.ones(1),
            true_demands=np.ones((1, 2)), kernel="pallas", device="cpu")


VERBATIM = ("policies", "cluster_state", "preemption", "faults", "invariants",
            "journal", "epoch_cache", "tenancy", "metrics", "workloads")


@pytest.mark.parametrize("name", VERBATIM)
def test_copied_module_differs_only_in_imports(name):
    """The jax-free modules are copies of the reference's: with the
    package name mapped back, the files are identical."""
    with open(os.path.join(ROOT, "src", "repro", "core", f"{name}.py")) as f:
        ref = f.read()
    with open(os.path.join(PKG, "core", f"{name}.py")) as f:
        port = f.read()
    assert port.replace("repro_torch.", "repro.") == ref
