"""The port's ground rules, checked on the CPU.

- The port and ``chip_smoke.py`` import with ``jax``, ``flax``,
  ``msgpack``, ``cloudpickle`` and the JAX package blocked, and no source
  file names them in an import; the cluster runtime's modules import
  without ``torch``.
- Entry points raise without CUDA unless the CPU is asked for.
- A CPU tensor passed to each kernel wrapper takes the plain version
  (the launch counts stay 0); each kernel's CUDA source exists, names
  the TPU function it replaces and is built by ``ops/_build.py``.
- Unported flags (every JAX serve flag the port lacks), fields and
  train-step options raise instead of being ignored.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import (benchmarks, convert, export, ops,
                                         optim, quantize, serve)
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.ops import _build
from tensorflowonspark_tpu_torch.ops import flash_attention as port_fa
from tensorflowonspark_tpu_torch.ops import fused_optim as port_fo
from tensorflowonspark_tpu_torch.ops import layernorm as port_ln
from tensorflowonspark_tpu_torch.ops import paged_attention as port_pa
from tensorflowonspark_tpu_torch.ops import paged_prefill as port_pp
from tensorflowonspark_tpu_torch.ops import quant_matmul as port_qm
from tensorflowonspark_tpu_torch.parallel import train as port_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tensorflowonspark_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "cloudpickle",
             "tensorflowonspark_tpu")
# the cluster runtime: executors and feeders import these without torch
# (a process that never loaded torch forks a clean node process)
TORCH_FREE = ("util", "faults", "marker", "gpu_info", "reservation",
              "manager", "shm", "feed", "node", "backend", "cluster",
              "parallel_runner", "compat")
TINY = dict(vocab_size=32, d_model=64, n_heads=4, n_kv_heads=2, n_layers=1,
            d_ff=64, max_seq_len=32, dtype="float32", rope=True)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _module_names():
    names = []
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        names.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                     else rel)
    return names


def test_imports_with_jax_blocked():
    assert "tensorflowonspark_tpu_torch.optim8bit" in _module_names()
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {_module_names()!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_cluster_runtime_imports_without_torch():
    assert set(TORCH_FREE) <= {m.rsplit(".", 1)[-1] for m in _module_names()}
    code = (
        "import importlib, sys\n"
        f"for mod in {TORCH_FREE!r}:\n"
        "    importlib.import_module('tensorflowonspark_tpu_torch.' + mod)\n"
        "print('torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"


def test_no_source_imports_jax_or_the_jax_package():
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if not node.level else []
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = port_tf.build_transformer(**TINY)
    export.export_saved_model(str(tmp_path), model.state_dict(),
                              builder_kwargs=TINY)
    args = serve.build_argparser().parse_args([
        "--export_dir", str(tmp_path), "--port", "0",
        "--generate_kv_page_size", "8", "--generate_kv_pages", "8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.make_server(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.GenerateService(str(tmp_path), kv_page_size=8, kv_pages=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.ContinuousBatcher(model, kv_page_size=8, kv_pages=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_decode.generate(model, [[1, 2, 3]], 2)


def test_cpu_tensors_take_the_plain_versions():
    ops.reset_launch_counts()
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(2, 4, 4, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 4, 2, 16).astype(np.float32))
    pk = torch.from_numpy(rng.randn(9, 8, 2, 16).astype(np.float32))
    pv = torch.from_numpy(rng.randn(9, 8, 2, 16).astype(np.float32))
    table = torch.tensor([[0, 1, 8], [2, 3, 8]], dtype=torch.int32)
    starts = torch.tensor([0, 5], dtype=torch.int32)
    lengths = starts + 4
    out = port_pa.paged_attention(q, pk, pv, table, lengths)
    want = port_pa.paged_attention_plain(q, pk, pv, table, lengths)
    assert torch.equal(out, want)
    pk2, pv2 = pk.clone(), pv.clone()
    port_pp._write_pages(k, k, pk, pv, table, starts)
    port_pp.write_pages_plain(k, k, pk2, pv2, table, starts)
    assert torch.equal(pk, pk2) and torch.equal(pv, pv2)
    out = port_pp._read_attention(q, k, k, pk, pv, table, starts)
    want = port_pp.read_attention_plain(q, k, k, pk, pv, table, starts)
    assert torch.equal(out, want)
    v = torch.from_numpy(rng.randn(2, 4, 2, 16).astype(np.float32))
    out, lse = port_fa.flash_fwd(q, k, v)
    want, want_lse = port_fa.flash_fwd_plain(q, k, v)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    delta = torch.einsum("bshd,bshd->bhs", q, out)
    assert torch.equal(port_fa.flash_bwd_dq(q, k, v, q, lse, delta),
                       port_fa.flash_bwd_dq_plain(q, k, v, q, lse, delta))
    for a, b in zip(port_fa.flash_bwd_dkv(q, k, v, q, lse, delta),
                    port_fa.flash_bwd_dkv_plain(q, k, v, q, lse, delta)):
        assert torch.equal(a, b)
    g, p, nu = (torch.from_numpy(rng.rand(37).astype(np.float32))
                for _ in range(3))
    mu = torch.zeros(37, dtype=torch.bfloat16)
    scal = torch.tensor([1e-3, 1.0, 0.1, 0.001])
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.1, write_param=True)
    want = port_fo.adamw_plain(g, p, mu, nu, scal, **kw)
    port_fo._adamw(g, p, mu, nu, scal, p, **kw)
    for a, b in zip((p, mu, nu), want):
        assert torch.equal(a, b)
    kw = dict(b1=0.9, b2=0.99, wd=0.1, write_param=False)
    out = torch.empty_like(g)
    want = port_fo.lion_plain(g, p, mu, scal, **kw)
    port_fo._lion(g, p, mu, scal, out, **kw)
    assert torch.equal(out, want[0]) and torch.equal(mu, want[1])
    x = torch.from_numpy(rng.randn(3, 200).astype(np.float32))
    w8 = quantize.quantize_int8(torch.from_numpy(
        rng.randn(200, 24).astype(np.float32)))
    w4 = quantize.int4_pack(torch.from_numpy(
        rng.randn(200, 24).astype(np.float32)), 128)
    assert torch.equal(port_qm._int8_matmul(x, w8),
                       port_qm.int8_matmul_plain(x, w8))
    assert torch.equal(port_qm._int4_matmul(x, w4),
                       port_qm.int4_matmul_plain(x, w4))
    # int8 kv pools: the quantising write, both reads
    pools = [torch.zeros((9, 8, 2, 16), dtype=torch.int8) for _ in range(2)]
    scales = [torch.zeros((9, 8, 2)) for _ in range(2)]
    pools2 = [t.clone() for t in pools + scales]
    ck, cv = port_pp._write_pages_int8(k, v, *pools, *scales, table, starts)
    want = port_pp.write_pages_plain(k, v, pools2[0], pools2[1], table,
                                     starts, pools2[2], pools2[3])
    assert torch.equal(ck, want[0]) and torch.equal(cv, want[1])
    for a, b in zip(pools + scales, pools2):
        assert torch.equal(a, b)
    sc = dict(key_scales=scales[0], value_scales=scales[1])
    assert torch.equal(
        port_pp._read_attention(q, ck, cv, *pools, table, starts, **sc),
        port_pp.read_attention_plain(q, ck, cv, *pools, table, starts, **sc))
    assert torch.equal(
        port_pa.paged_attention(q, *pools, table, lengths, **sc),
        port_pa.paged_attention_plain(q, *pools, table, lengths, **sc))
    w, b = torch.rand(200), torch.rand(200)
    assert torch.equal(port_ln._layernorm(x, w, b, 1e-6),
                       port_ln.layernorm_plain(x, w, b, 1e-6))
    assert ops.launch_counts() == {
        "paged_attention": 0, "page_write": 0, "prefill_read": 0,
        "paged_attention_int8": 0, "page_write_int8": 0,
        "prefill_read_int8": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
        "flash_bwd_dkv": 0, "adamw": 0, "lion": 0, "int8_matmul": 0,
        "int4_matmul": 0, "layernorm": 0}


def test_kernel_sources_exist_and_are_built():
    csrc = os.path.join(PKG, "csrc")
    replaces = {"paged_attention.cu": ["_decode_kernel"],
                "paged_prefill.cu": ["_page_write_kernel",
                                     "_prefill_read_kernel"],
                "flash_attention.cu": ["_fwd_kernel", "_bwd_dq_kernel",
                                       "_bwd_dkv_kernel"],
                "fused_optim.cu": ["_adamw_kernel", "_lion_kernel"],
                "quant_matmul.cu": ["_int8_kernel", "_int4_kernel"],
                "layernorm.cu": ["_ln_kernel"]}
    assert sorted(_build.SOURCES) == sorted(replaces)
    for src, tpu_fns in replaces.items():
        with open(os.path.join(csrc, src)) as f:
            text = f.read()
        for fn in tpu_fns:
            assert fn in text, (src, fn)
        assert 'extern "C"' in text
    for name in _build.SIGNATURES:
        assert any(name in open(os.path.join(csrc, s)).read()
                   for s in _build.SOURCES), name
    assert _build.ARCH_FLAGS == ["-gencode", "arch=compute_90a,code=sm_90a"]


@pytest.mark.parametrize("flag", [
    ["--generate_engine", "async"], ["--generate_preempt_ms", "5"], ["--spec_draft", "ngram"],
    ["--generate_lora_rank", "2"], ["--generate_host_cache_mb", "4"],
    # the JAX server's flags the port's parser lacked
    ["--generate_lora", "a=b.npz"], ["--generate_lora_capacity", "8"],
    ["--draft_k", "4"], ["--generate_pipeline_depth", "2"],
    ["--generate_priority_weight", "4"], ["--generate_park_capacity", "8"],
    ["--generate_trace_ring", "4096"],
    ["--generate_trace_decode_sample", "16"],
    ["--generate_paged_attn", "einsum"],
    ["--generate_paged_prefill", "blend"], ["--role", "prefill"],
    ["--advertise_host", "10.0.0.1"], ["--fleet_heartbeat_s", "2.0"],
    ["--engine", "native"], ["--batch_size", "64"],
    ["--batch_wait_ms", "5"], ["--input_mapping", "x"],
    ["--output_mapping", "y"], ["--signature_def_key", "serving_default"]])
def test_unported_flags_raise(flag):
    args = serve.build_argparser().parse_args([
        "--export_dir", "unused", "--device", "cpu",
        "--generate_kv_page_size", "8", "--generate_kv_pages", "8", *flag])
    name = flag[0].lstrip("-")
    with pytest.raises(NotImplementedError,
                       match=f"--{name}=.* not ported yet \\(ROADMAP: "):
        serve.make_server(args)


def test_training_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmarks.make_flagship_step(2, 16)


@pytest.mark.parametrize("kw", [{"mesh": object()},
                                {"param_shardings": {}},
                                {"donate": False}])
def test_unported_train_step_options_raise(kw):
    opt, _ = optim.make_optimizer("adamw_fused")
    with pytest.raises(NotImplementedError, match="not ported"):
        port_train.make_train_step(lambda m, b, r: 0.0, opt, **kw)
    if "donate" not in kw:
        model = port_tf.build_transformer(**TINY)
        with pytest.raises(NotImplementedError, match="not ported"):
            port_train.create_train_state(model, opt, **kw)


def test_convert_roundtrip_keeps_the_jax_layout():
    model = port_tf.build_transformer(**dict(TINY, use_bias=True))
    sd = model.state_dict()
    tree = convert.params_to_jax(sd)
    assert tree["layer_0"]["attn"]["query"]["kernel"].shape == (64, 64)
    assert tree["layer_0"]["attn"]["key"]["kernel"].shape == (64, 32)
    assert tree["token_embed"]["embedding"].shape == (32, 64)
    assert set(tree["ln_f"]) == {"scale", "bias"}
    back = convert.params_from_jax(tree)
    assert set(back) == set(sd)
    for name, t in sd.items():
        assert torch.equal(back[name], t), name
