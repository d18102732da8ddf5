"""The port's ground rules, checked on the CPU.

- The port, ``chip_smoke.py`` and the port's MNIST example import with
  ``jax``, ``flax``, ``orbax``, ``msgpack``, ``cloudpickle`` and the JAX
  package blocked, and no source file names them in an import;
  ``transformers`` and PIL are imported inside functions only (the
  example imports with them blocked too); the cluster runtime's modules,
  ``utils`` and ``image`` import without ``torch``, and so do the
  example's files.
- Entry points raise without CUDA unless the CPU is asked for.
- A CPU tensor passed to each kernel wrapper takes the plain version
  (the launch counts stay 0); each kernel's CUDA source exists, names
  the TPU function it replaces and is built by ``ops/_build.py``.
- Unported flags (the JAX server's two switches to its plain read
  paths), fields and train-step options raise instead of being ignored;
  the :predict flags and ``--engine`` build a server over the port's
  artifacts and each takes effect; the replica's
  fleet flags (host tier, roles, priorities, preemption, tracing) are
  ported and build a server; ``--fleet`` and ``--fleet_heartbeat_s``
  register the replica with a port gateway, announcing the features
  the JAX server announces, key for key.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import (aot, benchmarks, convert, export,
                                         fleet, fleet_client, ops, optim,
                                         quantize, serve)
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.ops import _build
from tensorflowonspark_tpu_torch.ops import flash_attention as port_fa
from tensorflowonspark_tpu_torch.ops import fused_optim as port_fo
from tensorflowonspark_tpu_torch.ops import layernorm as port_ln
from tensorflowonspark_tpu_torch.ops import paged_attention as port_pa
from tensorflowonspark_tpu_torch.ops import paged_prefill as port_pp
from tensorflowonspark_tpu_torch.ops import quant_matmul as port_qm
from tensorflowonspark_tpu_torch.parallel import mesh as port_mesh
from tensorflowonspark_tpu_torch.parallel import sharding as port_sharding
from tensorflowonspark_tpu_torch.parallel import train as port_train

from torch_aot_vit import vit_aot_export  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tensorflowonspark_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
             "cloudpickle", "tensorflowonspark_tpu")
# optional packages: imported only inside the functions that need them
LAZY = ("transformers", "PIL")
# the port's MNIST example (examples/mnist), beside the JAX one
EXAMPLES = ("torch_mnist_data_setup", "torch_mnist_common",
            "torch_mnist_spark")
EXAMPLE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "mnist")
# the cluster runtime, the data layer and the pipeline API: executors
# and feeders import these without torch (a process that never loaded
# torch forks a clean node process); tracing and the metrics a fleet
# gateway reads too; the fleet gateway, its client and bulk jobs
TORCH_FREE = ("util", "faults", "marker", "gpu_info", "reservation",
              "manager", "shm", "feed", "node", "backend", "cluster",
              "parallel_runner", "compat", "fsio", "schema", "tfrecord",
              "data", "minispark", "minispark.executor", "minispark.sql",
              "minispark.sql.types", "minispark.ml", "minispark.streaming",
              "dfutil", "pipeline", "pipeline_ml", "trace", "metrics",
              "fleet", "fleet_client", "jobs", "utils", "utils.checkpoint",
              "utils.summary", "utils.profiling", "image")
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
    for mod in ("common", "mlp", "linear", "cnn", "resnet", "unet",
                "deeplab", "vit", "bert"):
        assert f"tensorflowonspark_tpu_torch.models.{mod}" in _module_names()
    assert "tensorflowonspark_tpu_torch.ops.xent" in _module_names()
    for mod in ("kvtier", "kvtransfer", "trace", "image", "utils",
                "utils.checkpoint", "utils.summary", "aot",
                "utils.profiling"):
        assert f"tensorflowonspark_tpu_torch.{mod}" in _module_names()
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
    prefix = "tensorflowonspark_tpu_torch."
    assert set(TORCH_FREE) <= {m[len(prefix):] for m in _module_names()
                               if m.startswith(prefix)}
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


def test_examples_import_with_jax_blocked():
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN + LAZY!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {EXAMPLE_DIR!r})\n"
        "import importlib\n"
        f"for mod in {EXAMPLES!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('torch' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # the executors of --platform cuda must not load torch before their
    # node process does
    assert res.stdout.strip() == "False"


def _imports(tree):
    """``(module, at module level)`` of every absolute import."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if not node.level else []
        else:
            continue
        for mod in mods:
            yield mod, id(node) in top


def test_examples_and_optional_packages_import_rules():
    paths = _port_sources() + [os.path.join(EXAMPLE_DIR, m + ".py")
                               for m in EXAMPLES]
    lazy_seen = set()
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for mod, top in _imports(tree):
            root = mod.split(".")[0]
            assert root not in FORBIDDEN, (path, mod)
            if root in LAZY:
                lazy_seen.add(root)
                assert not top, (path, mod)
    assert lazy_seen == set(LAZY)


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


def test_loaders_pipeline_and_cli_follow_the_device_rule(monkeypatch,
                                                        tmp_path,
                                                        vit_aot_export):
    from tensorflowonspark_tpu_torch import dfutil, inference, pipeline

    model = port_tf.build_transformer(**TINY)
    export.export_saved_model(str(tmp_path), model.state_dict(),
                              builder_kwargs=TINY)
    rows = [[(np.arange(4, dtype=np.int32),)]]
    loaded, _ = export.load_model(str(tmp_path), device="cpu")
    predict, _ = export.load_saved_model(str(tmp_path), device="cpu")
    assert predict.device.type == "cpu" and predict(np.stack(
        [r[0] for r in rows[0]])).shape == (1, 4, TINY["vocab_size"])
    assert len(pipeline.TFModel({"export_dir": str(tmp_path),
                                 "device": "cpu"}).transform(rows)) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_model(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_saved_model(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.TFModel({"export_dir": str(tmp_path)}).transform(rows)
    shard = str(tmp_path / "part-r-00000")
    dfutil.write_tfrecords([{"input": list(range(4))}], shard)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main(["--export_dir", str(tmp_path), "--input", shard,
                        "--output", str(tmp_path / "out")])
    # aot_batch_sizes compiles on the card unless the CPU is asked for
    sig = {"serving_default": {"inputs": {"input": {"shape": [4],
                                                    "dtype": "int32"}},
                               "outputs": ["output"]}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.export_saved_model(str(tmp_path / "x"), model.state_dict(),
                                  builder_kwargs=TINY, signatures=sig,
                                  aot_batch_sizes=[8])
    assert not os.path.exists(tmp_path / "x")
    # with device="cpu" it writes both forms for the CPU (the shared
    # fixture's export)
    vdir, _, _ = vit_aot_export
    assert aot.read_spec(vdir)["devices"] == ["cpu"]
    assert sorted(os.listdir(os.path.join(vdir, "aot"))) == [
        "aot_spec.json", "model_b4.cpu.aoti.pt2", "model_b4.cpu.pt2"]
    assert export.export_saved_model(str(tmp_path / "y"), model.state_dict(),
                                     is_chief=False) is None
    assert not os.path.exists(tmp_path / "y")


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
    # the JAX server's switches to its plain XLA read paths
    ["--generate_paged_attn", "einsum"],
    ["--generate_paged_prefill", "blend"]])
def test_unported_flags_raise(flag):
    args = serve.build_argparser().parse_args([
        "--export_dir", "unused", "--device", "cpu",
        "--generate_kv_page_size", "8", "--generate_kv_pages", "8", *flag])
    name = flag[0].lstrip("-")
    with pytest.raises(NotImplementedError,
                       match=f"--{name}=.* is refused: the port's paged "
                             "kernel wrappers take no switch"):
        serve.make_server(args)


@pytest.mark.parametrize("flag,effect", [
    (["--engine", "native"], "aot(engine=native"),
    (["--engine", "jax"], "aot(engine=jax"),
    (["--engine", "builder"], "builder(batch=64"),
    (["--batch_size", "3"], "aot(engine=native, batch=4"),
    (["--batch_wait_ms", "5"], "batcher"),
    (["--input_mapping", '{"pixels": "image"}'], "pixels"),
    (["--output_mapping", '{"logits": "scores"}'], "scores"),
    (["--signature_def_key", "serving_default"], "aot(engine=native")])
def test_predict_flags_are_ported(vit_aot_export, flag, effect):
    """The :predict flags and ``--engine`` (refused until A8c) build a
    server over an export with the port's artifacts, and each takes
    effect: the engine and batch size in ``desc``, the micro-batcher,
    the renamed input and output, the signature."""
    d, _, _ = vit_aot_export
    args = serve.build_argparser().parse_args([
        "--export_dir", d, "--device", "cpu", "--port", "0", *flag])
    server, service = serve.make_server(args)
    try:
        if effect == "batcher":
            assert service._batcher is not None
            assert service._batcher._wait_s == 0.005
        elif effect == "pixels":
            assert service._predict_rows.input_names == ["pixels"]
        elif effect == "scores":
            out = service.predict([{"image": np.zeros((8, 8, 3)).tolist()}])
            assert list(out[0]) == ["scores"] and len(out[0]["scores"]) == 5
        else:
            assert service.desc.startswith(effect), service.desc
    finally:
        server.server_close()


@pytest.mark.parametrize("flag", [[], ["--fleet_heartbeat_s", "0.3"]])
def test_fleet_flags_register_a_replica(flag):
    """``--fleet`` (with the default heartbeat of 2 s, or a given one)
    builds a server and registers it with a port gateway; BYE drops it."""
    gw = fleet.Gateway(heartbeat_timeout_s=30.0)
    gw.start()
    args = serve.build_argparser().parse_args([
        "--export_dir", "unused", "--device", "cpu",
        "--generate_kv_page_size", "8", "--generate_kv_pages", "8",
        "--fleet", "%s:%d" % gw.registry_addr, *flag])
    server, service = serve.make_server(args)
    reg = None
    try:
        reg = serve._register_with_fleet(args, server, service)
        assert reg.heartbeat_interval_s == (float(flag[1]) if flag else 2.0)
        rid = "127.0.0.1:%d" % server.server_address[1]
        replicas = gw.fleet_stats(probe=False)["replicas"]
        assert list(replicas) == [rid]
        assert replicas[rid]["features"]["kv_page_size"] == 8
        assert replicas[rid]["role"] == "mixed"
        reg.deregister()
        assert gw.counters.get("deregistrations") == 1
        assert gw.fleet_stats(probe=False)["replicas"] == {}
    finally:
        if reg is not None:
            reg.deregister()
        server.server_close()
        gw.stop()


class _FakeEngine:
    def prefix_addr(self):
        return "10.0.0.1:7400"


class _FakeService:
    def migration_engine(self):
        return _FakeEngine()


def test_fleet_features_match_the_jax_servers(monkeypatch):
    """The meta a replica registers with (id, slots, heartbeat and the
    ``features`` dict, key for key) is the JAX server's for the same
    flags; a malformed ``--fleet`` raises in both."""
    from tensorflowonspark_tpu import fleet_client as jax_fleet_client
    from tensorflowonspark_tpu import serve as jax_serve

    seen = {}
    for name, mod in (("jax", jax_fleet_client), ("port", fleet_client)):
        monkeypatch.setattr(
            mod, "register_replica",
            lambda addr, host, port, _n=name, **kw: seen.setdefault(
                _n, []).append((addr, host, port, kw)))
    server = type("S", (), {"server_address": ("127.0.0.1", 8501)})()
    common = ["--export_dir", "unused", "--port", "0", "--fleet", "gw:8400"]
    for extra in (
            [],
            ["--generate_kv_page_size", "8", "--generate_kv_pages", "64",
             "--generate_host_cache_mb", "4",
             "--generate_long_prompt_threshold", "64",
             "--spec_draft", "ngram", "--draft_k", "3",
             "--generate_quantize", "int8", "--generate_lora_rank", "4",
             "--generate_prefill_rows", "2", "--role", "prefill",
             "--generate_preempt_ms", "5", "--advertise_host", "10.0.0.9",
             "--generate_slots", "6", "--fleet_heartbeat_s", "0.5"],
            ["--draft_export_dir", "d", "--generate_engine", "serial",
             "--role", "decode", "--model_name", "m"]):
        for name, mod in (("jax", jax_serve), ("port", serve)):
            args = mod.build_argparser().parse_args(common + extra)
            mod._register_with_fleet(args, server, _FakeService())
        assert seen["port"][-1] == seen["jax"][-1], extra
    assert seen["port"][1][3]["features"]["kv_prefix_addr"] == \
        "10.0.0.1:7400"
    for mod in (jax_serve, serve):
        args = mod.build_argparser().parse_args(
            ["--export_dir", "unused", "--fleet", "no-port"])
        with pytest.raises(ValueError, match="HOST:PORT"):
            mod._register_with_fleet(args, server)


@pytest.mark.parametrize("flag", [
    ["--generate_preempt_ms", "5"], ["--generate_host_cache_mb", "4"],
    ["--generate_priority_weight", "4"], ["--generate_park_capacity", "8"],
    ["--generate_trace_ring", "4096"],
    ["--generate_trace_decode_sample", "16"], ["--role", "prefill"],
    ["--advertise_host", "10.0.0.1"]])
def test_replica_fleet_flags_are_ported(flag):
    args = serve.build_argparser().parse_args([
        "--export_dir", "unused", "--device", "cpu",
        "--generate_kv_page_size", "8", "--generate_kv_pages", "8", *flag])
    server, service = serve.make_server(args)
    try:
        name = flag[0].lstrip("-")
        assert getattr(args, name) == type(getattr(args, name))(flag[1])
        assert service.role == args.role
    finally:
        server.server_close()


def test_training_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmarks.make_flagship_step(2, 16)


def _lm_loss(m, b, r):
    return port_tf.lm_loss(m(b[:, :-1]), b[:, 1:])


@pytest.mark.parametrize("kw", [{"mesh": object()},
                                {"param_shardings": {}},
                                {"donate": False}])
def test_unported_train_step_options_raise(kw):
    """A dp / fsdp mesh (of one rank here) and its ``param_shardings``
    build a state and a step, ``donate=False`` keeps its input state.  A
    tp=2 mesh places once it has ranks (abstract, it raises for lack of
    them), and the context- and sequence-parallel config fields build a
    model; what stays unported (those fields on another axis than tp,
    sp with cp) raises naming A3c."""
    opt, _ = optim.make_optimizer("adamw_fused")
    model = port_tf.build_transformer(**TINY)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 32,
                                                               (2, 9)))
    mesh = port_mesh.build_mesh(port_mesh.MeshSpec(fsdp=1), device="cpu")
    if "mesh" in kw:
        state = port_train.create_train_state(model, opt, mesh)
        step = port_train.make_train_step(_lm_loss, opt, mesh)
        tp = port_mesh.Mesh(port_mesh.MeshSpec(dp=1, tp=2).resolve(2))
        for call in (lambda: port_train.make_train_step(_lm_loss, opt, tp),
                     lambda: port_train.create_train_state(model, opt, tp),
                     lambda: port_train.make_eval_step(_lm_loss, tp)):
            with pytest.raises(ValueError, match="abstract"):
                call()
    elif "param_shardings" in kw:
        sh = port_sharding.infer_param_shardings(model, mesh, fsdp=True)
        state = port_train.create_train_state(model, opt,
                                              param_shardings=sh)
        step = port_train.make_train_step(_lm_loss, opt, param_shardings=sh)
        assert state.shardings is sh
        for field in ("ring_attention_axis", "ulysses_axis", "sp_axis"):
            # on one rank the split forward computes the plain one (the
            # ring's online softmax sums in another order)
            split = port_tf.build_transformer(**dict(TINY, **{field: "tp"}))
            split.load_state_dict(model.state_dict())
            with port_mesh.use_mesh(mesh), torch.no_grad():
                torch.testing.assert_close(split(tokens), model(tokens),
                                           rtol=1e-5, atol=1e-5)
            with pytest.raises(NotImplementedError, match=r"ROADMAP A3c"):
                port_tf.build_transformer(**dict(TINY, **{field: "dp"}))
        with pytest.raises(ValueError, match="mutually exclusive"):
            port_tf.build_transformer(**dict(
                TINY, ring_attention_axis="tp", ulysses_axis="tp"))
        with pytest.raises(NotImplementedError, match=r"ROADMAP A3c"):
            port_tf.build_transformer(**dict(
                TINY, ring_attention_axis="tp", sp_axis="tp"))
    else:
        state = port_train.create_train_state(model, opt)
        step = port_train.make_train_step(_lm_loss, opt, donate=False)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    new, metrics = step(state, tokens, None)
    assert torch.isfinite(metrics["loss"]) and int(new.step) == 1
    kept = all(torch.equal(p, before[n]) for n, p in
               state.params.named_parameters())
    assert kept == ("donate" in kw)
    if "donate" in kw:
        assert int(state.step) == 0 and int(state.opt_state.count) == 0
        assert new.params is not state.params


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
