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
    assert {"repro_torch.core.engine_torch", "repro_torch.launch.alloc_serve",
            "repro_torch.launch.cluster_sim",
            "repro_torch.cluster.gang", "repro_torch.launch.serve",
            "repro_torch.models.common", "repro_torch.models.lm",
            "repro_torch.models.rwkv", "repro_torch.models.hymba",
            "repro_torch.models.encdec",
            "repro_torch.nn.config",
            "repro_torch.nn.param", "repro_torch.nn.layers",
            "repro_torch.nn.ssm", "repro_torch.configs",
            "repro_torch.configs.qwen2_1_5b", "repro_torch.configs.rwkv6_3b",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.flash_attention.ref",
            "repro_torch.kernels.rwkv6.ops",
            "repro_torch.kernels.rwkv6.ref",
            "repro_torch.core.filling_torch", "repro_torch.core.filling",
            "repro_torch.core.instance", "repro_torch.core.fairness",
            "repro_torch.configs.paper_cluster",
            "repro_torch.launch.paper_tables",
            "repro_torch.launch.paper_figures",
            "repro_torch.launch.fig9_adaptation",
            "repro_torch.launch.mesh", "repro_torch.launch.train",
            "repro_torch.train.steps", "repro_torch.optim.adamw",
            "repro_torch.optim.compress", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.store", "repro_torch.fault.tolerance",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.strategy", "repro_torch.launch.inputs",
            "repro_torch.launch.dryrun", "repro_torch.launch.trace_analysis",
            "repro_torch.tree"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


PORT_FILES = sorted(
    [os.path.join(d, f) for d, _s, fs in os.walk(PKG) for f in fs
     if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")])


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_file_imports_jax_or_reference(path):
    with open(path) as f:
        text = f.read()
    assert not _IMPORT.findall(text)
    assert "jnp" not in text


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_file_imports_triton(path):
    """Every kernel of the port is CUDA C++ under ``csrc/``."""
    with open(path) as f:
        text = f.read()
    assert not re.findall(r"^\s*(?:from|import)\s+triton\b", text,
                          re.MULTILINE)


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.cluster.gang import GangScheduler
    from repro_torch.core import engine_torch
    from repro_torch.core.online import OnlineAllocator
    from repro_torch.core.simulator import (HETEROGENEOUS_AGENTS, PI, WC,
                                            SimConfig, SparkMesosSim)
    from repro_torch.launch.alloc_serve import AllocatorService

    with pytest.raises(RuntimeError, match="CUDA"):
        OnlineAllocator(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        SparkMesosSim(HETEROGENEOUS_AGENTS, {"Pi": PI, "WordCount": WC},
                      SimConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        GangScheduler()
    with pytest.raises(RuntimeError, match="CUDA"):
        AllocatorService(2, [("a0", (4.0, 4.0))])
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_torch.run_epoch(
            "drf", "pooled", X=np.zeros((1, 1)), D=np.ones((1, 2)),
            C=np.ones((1, 2)), FREE=np.ones((1, 2)), phi=np.ones(1),
            allowed=np.ones((1, 1), bool), wanted=np.ones(1),
            true_demands=np.ones((1, 2)))


def _pergrant_fill(crit, pol, allowed, monkeypatch):
    """-> (grants on use_kernel="pergrant", grants on the numpy epoch,
    calls of K4's plain version, K4 launches) on the CPU."""
    from repro_torch.core.online import OnlineAllocator
    from repro_torch.kernels.psdsf_score import ops

    calls = []
    plain = ops.psdsf_argmin_ref

    def spy(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(ops, "psdsf_argmin_ref", spy)
    launches = ops.psdsf_argmin.launches
    out = {}
    for uk in ("pergrant", False):
        al = OnlineAllocator(2, criterion=crit, server_policy=pol, seed=0,
                             device="cpu")
        for j, cap in enumerate(((4.0, 14.0), (8.0, 8.0), (6.0, 11.0))):
            al.add_agent(f"a{j}", cap)
        al.register("f0", demand=(2.0, 2.0), wanted_tasks=4, phi=2.0,
                    allowed_agents=["a0", "a1"] if not allowed else None)
        al.register("f1", demand=(1.0, 3.5), wanted_tasks=10**6)
        out[uk] = [(g.fid, g.agent) for g in al.allocate_batched(
            use_kernel=uk)]
    return out["pergrant"], out[False], len(calls), (
        ops.psdsf_argmin.launches - launches)


@pytest.mark.parametrize("crit,pol,allowed", [
    ("rpsdsf", "pooled", True), ("rpsdsf", "pooled", False),
    ("rpsdsf", "rrr", True), ("psdsf", "pooled", True),
    ("drf", "pooled", True)])
def test_pergrant_backend_engages_k4(crit, pol, allowed, monkeypatch):
    """``use_kernel="pergrant"`` picks every grant with K4 (on the CPU its
    plain version, once a grant and once more for the pick that ends the
    epoch; no launch) where the reference engages its kernel, and runs
    the numpy epoch everywhere else, as the reference does.  The card's
    side (the launch counter moves) is in tests/test_torch_cuda.py."""
    from repro.core.engine import BatchedEpoch as RefEpoch
    from repro_torch.core.engine import BatchedEpoch

    kw = dict(X=np.zeros((2, 3)), D=np.ones((2, 2)), C=np.full((3, 2), 4.0),
              FREE=np.full((3, 2), 4.0), phi=np.ones(2),
              allowed=np.array([[True] * 3, [allowed, True, True]]),
              wanted=np.full(2, 5.0), true_demands=np.ones((2, 2)),
              rng=np.random.default_rng(0), use_kernel=True)
    engaged = RefEpoch(crit, pol, **kw).kernel
    assert BatchedEpoch(crit, pol, device="cpu", **kw).kernel == engaged
    assert engaged == (crit == "rpsdsf" and pol == "pooled" and allowed)
    k4, numpy_grants, calls, launches = _pergrant_fill(crit, pol, allowed,
                                                       monkeypatch)
    assert launches == 0 and k4
    assert calls == (len(k4) + 1 if engaged else 0)
    if not engaged:
        assert k4 == numpy_grants


def test_unknown_epoch_kernel_refused():
    from repro_torch.core import engine_torch

    with pytest.raises(ValueError, match="epoch kernel"):
        engine_torch.run_epoch(
            "drf", "pooled", X=np.zeros((1, 1)), D=np.ones((1, 2)),
            C=np.ones((1, 2)), FREE=np.ones((1, 2)), phi=np.ones(1),
            allowed=np.ones((1, 1), bool), wanted=np.ones(1),
            true_demands=np.ones((1, 2)), kernel="pallas", device="cpu")


VERBATIM = ("policies", "cluster_state", "preemption", "faults", "invariants",
            "journal", "epoch_cache", "tenancy", "metrics", "workloads",
            "instance", "filling", "fairness")


@pytest.mark.parametrize("name", VERBATIM)
def test_copied_module_differs_only_in_imports(name):
    """The jax-free modules are copies of the reference's: with the
    package name mapped back, the files are identical."""
    with open(os.path.join(ROOT, "src", "repro", "core", f"{name}.py")) as f:
        ref = f.read()
    with open(os.path.join(PKG, "core", f"{name}.py")) as f:
        port = f.read()
    assert port.replace("repro_torch.", "repro.") == ref


CONFIG_FILES = ("__init__", "shapes", "gemma3_12b", "qwen3_8b",
                "mistral_nemo_12b", "qwen2_1_5b", "whisper_large_v3",
                "rwkv6_3b", "llama32_vision_90b", "deepseek_v2_236b",
                "granite_moe_3b", "hymba_1_5b", "paper_cluster")


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_copied_config_differs_only_in_imports(name):
    """The architecture configs are copies of the reference's."""
    with open(os.path.join(ROOT, "src", "repro", "configs",
                           f"{name}.py")) as f:
        ref = f.read()
    with open(os.path.join(PKG, "configs", f"{name}.py")) as f:
        port = f.read()
    assert port.replace("repro_torch.", "repro.") == ref


def test_serve_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="CUDA"):
        serve.serve("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "rwkv6-3b"])


def _variant(arch, **kw):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch, smoke=True), **kw)


#: deepseek-smoke's MLA dims, for configs that switch MLA on
MLA_DIMS = dict(use_mla=True, q_lora_rank=0, kv_lora_rank=16, qk_nope_dim=16,
                qk_rope_dim=8, v_head_dim=16)


@pytest.mark.parametrize("name", ["hymba-1.5b", "whisper-large-v3",
                                  "llama-3.2-vision-90b"],
                         ids=["hymba", "whisper", "llama-vision"])
def test_unported_families_raise(name):
    """No family raises any more (the name is the test's history: it held
    the refusals while families were left to port).  The families ported
    last, the hybrid, enc-dec and VLM families: hymba, whisper and
    llama-3.2-vision resolve to the port's ``hymba``, ``encdec`` and
    ``vlm`` modules, from the full config and the smoke config, and their
    smoke configs serve on the CPU, no kernel launched."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import encdec, hymba, vlm
    from repro_torch.models.common import get_family

    cfg = get_config(name, smoke=True)
    mod = {"hybrid": hymba, "encdec": encdec, "vlm": vlm}[cfg.family]
    assert get_family(get_config(name)) is mod
    assert get_family(cfg) is mod
    out = serve.serve(name, device="cpu", batch=2, prompt_len=8, gen=4)
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()
    assert not any(n for phase in out["launches"].values()
                   for n in phase.values())


@pytest.mark.parametrize("make", [
    lambda: "deepseek-v2-236b",
    lambda: _variant("granite_moe_3b", **MLA_DIMS),
    lambda: _variant("qwen2_1_5b", n_experts=4, experts_per_token=2,
                     **MLA_DIMS),
    lambda: _variant("qwen2_1_5b", **MLA_DIMS),
], ids=["deepseek", "granite", "dense+moe", "dense+mla"])
def test_mla_configs_build_and_serve(make):
    """MLA attention is ported: deepseek-v2 (its full config and its smoke
    config) and MLA switched on in a MoE config (granite), in a dense config
    with experts and in a dense one resolve to the port's ``lm`` through
    ``get_family``, and the smoke configs serve on the CPU: finite greedy
    tokens, no kernel launched."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.common import get_family

    cfg = make()
    if isinstance(cfg, str):
        assert get_family(get_config(cfg)) is lm
        cfg = get_config(cfg, smoke=True)
    assert get_family(cfg) is lm
    assert "attn" in lm.layer_template(cfg)
    out = serve.serve(cfg, device="cpu", batch=2, prompt_len=8, gen=4)
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()
    assert not any(n for phase in out["launches"].values()
                   for n in phase.values())


def test_ported_families_resolve():
    from repro_torch.configs import get_config
    from repro_torch.models import hymba, lm, rwkv, vlm
    from repro_torch.models.common import get_family

    assert get_family(get_config("hymba-1.5b")) is hymba
    assert get_family(get_config("llama-3.2-vision-90b")) is vlm
    for arch in ("qwen2-1.5b", "qwen3-8b", "gemma3-12b", "mistral-nemo-12b",
                 "granite-moe-3b-a800m"):
        assert get_family(get_config(arch)) is lm
    assert get_family(get_config("rwkv6-3b")) is rwkv
