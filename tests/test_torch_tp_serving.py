"""The port's serving on a tp mesh against the JAX package, on the CPU.

Two gloo worlds, of 2 and of 4 ranks, run one after the other (each
rank its own interpreter, ``tests/torch_tp_serving_ranks.py``, torch and
the port only, every collective under a timeout), so that at most 4
rank processes load the CPU beside the test workers; under xdist the
workers share them through a lock in the session's temp root.  Each
world splits four small f32 LMs (2 layers, d_model 32 or 48, vocab 64)
over ``MeshSpec(tp=n)``:

- ``gqa8``: 8 heads over 2 kv heads, RoPE (the JAX package's
  ``test_generate_with_tp_sharded_params``): at tp 4 the kv projection
  splits mid-head, so each rank reads its kv head from the gathered
  weight;
- ``gqa4``: 4 heads over 2 kv heads, RoPE, dense attention (its
  ``test_slot_engine_serves_tp_sharded_params``);
- ``even``: 4 heads, 4 kv heads, learned positions (the kv heads split
  evenly, the position table split over d_model);
- ``uneven``: 12 heads over 3 kv heads, d_model 48, RoPE: a rank's q
  heads straddle the kv heads unevenly (at tp 4 the ranks read 1, 2, 2
  and 1 of them), so the ranks' caches hold different head counts and a
  cached forward regroups the queries.

Weights are numpy draws from a seed over the JAX trees' shapes
(``jax.eval_shape``), carried to the port by ``convert.params_from_jax``.
The JAX side runs here, unsharded.  Checked, at tp 2 and 4:

- (a) greedy ``generate`` gives JAX ``generate``'s tokens, and the
  first step's whole-vocabulary logits (a paged slot-cache prefill over
  the rank's kv heads) lie within atol 2e-5 / rtol 2e-5 of the JAX
  forward's;
- (b) seeded sampled ``generate`` gives the same tokens on every rank,
  equal to the port's at tp 1;
- (c) ``ContinuousBatcher``, dense and paged (the plain versions of
  kernels 1-3), async and serial, 3 requests each admitted after the
  previous one's first token: the JAX ``ContinuousBatcher``'s tokens;
- (d) an int8 kv pool with a prefix-cache hit, a table grow and a lane
  prompt, and the dense cache in int8 on the serial engine, each with a
  greedy, a sampled (filtered) and a penalised row: the port's tokens
  at tp 1 (and the leader's counters show each), and on the greedy and
  penalised rows the JAX batcher's tokens (the port's sampling noise is
  a counter hash, not JAX's threefry, so a sampled row is held to tp 1
  only);
- (e) two LoRA adapters on mixed rows: the port's tokens at tp 1 and
  the JAX batcher's; an adapter whose ``out`` banks alone are non-zero
  moves the logits, by the tp-1 model's delta;
- (f) every queued feature (the host tier, parking, kv migration, a dp
  axis) raises ``NotImplementedError`` naming ROADMAP A3c, and engines
  built with different arguments raise on every rank;
- (g) quantised weights (``gqa8`` and ``uneven``, every projection,
  int8 and int4 at a group that fits every row-parallel split), the
  whole masters quantised, then split: each rank's ``q`` / ``scale``
  equal, bit for bit, the JAX ``quantize_tree`` leaf of the whole tree
  sliced by the float weight's rule (column-parallel over N, row-parallel
  ``q`` and int4 group scales over K with the int8 scale whole, k / v
  that tp cannot split at whole heads: the rank's kv heads' columns);
- (h) ``generate`` of the first prompt on every rank and the dense and
  paged batchers (the plain versions of kernels 1-3, 9 and 10) give the JAX
  ``ContinuousBatcher``'s tokens on the unsharded quantised tree;
- (i) a stored int8 export, loaded as the server loads it
  (``serve._load_lm``), serves on the mesh with the same tokens;
- (j) an int4 group that straddles a row-parallel split raises
  ``NotImplementedError`` naming ROADMAP A3c;
- (k) n-gram and draft-model speculation (a 1-layer draft of the extras
  config's widths, split over the same mesh; paged serial engines that
  take one request at a time, a shared prefix so the draft catches up,
  and a dense async n-gram engine): greedy rows give JAX ``generate``'s
  tokens (greedy speculation's promise; the JAX batcher's draft engine
  breaks it on the prefix-cache hit), sampled rows the port's at tp 1,
  and on the engines that take one request at a time ``spec_rounds`` /
  ``spec_tokens_accepted`` / ``spec_k_mean`` equal tp 1's on every
  rank.

Tolerance: greedy tokens equal exactly (f32).
"""
import fcntl
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import quantize as jax_quantize
from tensorflowonspark_tpu import serve as jax_serve
from tensorflowonspark_tpu.models import decode as jax_decode
from tensorflowonspark_tpu.models import transformer as jax_tf

import torch_tp_serving_ranks as ranks_mod

HERE = os.path.dirname(os.path.abspath(__file__))
WORLDS = (2, 4)
BASE = dict(vocab_size=64, d_model=32, n_layers=2, d_ff=64, max_seq_len=128,
            dtype="float32")
CFGS = {"gqa8": dict(BASE, n_heads=8, n_kv_heads=2, rope=True),
        "gqa4": dict(BASE, n_heads=4, n_kv_heads=2, rope=True,
                     attention_impl="dense"),
        "even": dict(BASE, n_heads=4, n_kv_heads=4),
        "uneven": dict(BASE, d_model=48, n_heads=12, n_kv_heads=3,
                       rope=True)}
EXTRAS_CONFIG = "gqa4"
RANK = 4
NEW = 6
LOGIT_TOL = 2e-5
VARIANTS = ("dense_async", "dense_serial", "paged_async", "paged_serial")
REFUSED = ("host_tier", "preempt", "migration", "dp_axis")
QUANT_MODES = ("int8", "int4")
_STATE = {}


def _numpy_tree(cfg, seed):
    """A flax parameter tree of ``cfg``'s shapes filled from numpy:
    kernels N(0, 1/fan_in), embeddings N(0, 1), norm scales 1 + N(0,
    0.1^2), biases N(0, 0.1^2)."""
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**cfg))
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.randn(*s.shape).astype(np.float32)
        if "kernel" in name:
            return x / np.sqrt(s.shape[0])
        if "scale" in name:
            return 1.0 + 0.1 * x
        if "bias" in name:
            return 0.1 * x
        return x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _adapter(rng, cfg, projs, scale=1.0):
    hd = cfg["d_model"] // cfg["n_heads"]
    dims = {"query": cfg["d_model"], "key": cfg["n_kv_heads"] * hd,
            "value": cfg["n_kv_heads"] * hd, "out": cfg["d_model"]}
    return {f"layer_{i}/attn/{p}/kernel": {
        "a": (rng.randn(cfg["d_model"], RANK) * 0.3).astype(np.float32),
        "b": (rng.randn(RANK, dims[p]) * 0.3 * scale).astype(np.float32)}
        for i in range(cfg["n_layers"]) for p in projs}


def inputs():
    if "inputs" in _STATE:
        return _STATE["inputs"]
    rng = np.random.RandomState(11)
    prefix = rng.randint(0, 64, 32).tolist()
    cfg = CFGS[EXTRAS_CONFIG]
    _STATE["inputs"] = dict(
        cfgs=CFGS, extras_config=EXTRAS_CONFIG, rank=RANK,
        tp1_world=WORLDS[0],
        params={n: _numpy_tree(c, 3 + i)
                for i, (n, c) in enumerate(CFGS.items())},
        prompts=[rng.randint(0, 64, n).tolist() for n in (5, 19, 11)],
        gen_prompts=rng.randint(0, 64, (2, 6)).tolist(),
        extra_prompts=[prefix + rng.randint(0, 64, 3).tolist(),
                       prefix + rng.randint(0, 64, 5).tolist(),
                       rng.randint(0, 64, 70).tolist()],
        adapters={"a": _adapter(rng, cfg, ("query", "key", "value", "out")),
                  "b": _adapter(rng, cfg, ("query", "value", "out"))},
        draft_params=_numpy_tree(dict(cfg, n_layers=1), 20),
        out_only={EXTRAS_CONFIG: _adapter(rng, cfg, ("out",), scale=3.0)})
    return _STATE["inputs"]


def _run_worlds(d):
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inputs(), f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    rcs = {}
    for n in WORLDS:
        wd = d / f"tp{n}"
        wd.mkdir(exist_ok=True)
        (wd / "inputs.pkl").write_bytes((d / "inputs.pkl").read_bytes())
        procs, logs = [], []
        try:
            for r in range(n):
                log = open(wd / f"log{r}", "w")
                logs.append(log)
                procs.append(((n, r), subprocess.Popen(
                    [sys.executable,
                     os.path.join(HERE, "torch_tp_serving_ranks.py"),
                     str(r), str(n), str(wd)], stdout=log,
                    stderr=subprocess.STDOUT, env=env)))
            for key, p in procs:
                try:
                    rcs[key] = p.wait(timeout=240)
                except subprocess.TimeoutExpired:
                    rcs[key] = "timeout"
        finally:
            for _, p in procs:
                if p.poll() is None:
                    p.kill()
            for f in logs:
                f.close()
    if any(rc != 0 for rc in rcs.values()):
        tails = [(d / f"tp{n}" / f"log{r}").read_text()[-3000:]
                 for n, r in rcs]
        pytest.fail(f"ranks exited {rcs}:\n" + "\n".join(tails))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``{tp: [rank results]}`` of both worlds."""
    if "worlds" in _STATE:
        return _STATE["worlds"]
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / "torch_tp_serving_worlds"
    d.mkdir(exist_ok=True)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "done").exists():
            _run_worlds(d)
            (d / "done").touch()
    out = {}
    for n in WORLDS:
        out[n] = []
        for r in range(n):
            with open(d / f"tp{n}" / f"rank{r}.pkl", "rb") as f:
                out[n].append(pickle.load(f))
    _STATE["worlds"] = out
    return out


def _jax(name):
    """The JAX model and its parameters (jnp) of config ``name``."""
    key = ("jax", name)
    if key not in _STATE:
        jm = jax_tf.Transformer(jax_tf.TransformerConfig(**CFGS[name]))
        params = jax.tree_util.tree_map(jnp.asarray,
                                        inputs()["params"][name])
        _STATE[key] = (jm, params)
    return _STATE[key]


def _jax_generate(name):
    key = ("gen", name)
    if key not in _STATE:
        jm, params = _jax(name)
        prompt = jnp.asarray(inputs()["gen_prompts"], jnp.int32)
        toks = jax_decode.generate(jm, params, prompt, max_new_tokens=NEW)
        logits = jm.apply({"params": params}, prompt)[:, -1]
        _STATE[key] = (np.asarray(toks).tolist(), np.asarray(logits))
    return _STATE[key]


def _jax_batcher(name):
    key = ("batcher", name)
    if key not in _STATE:
        jm, params = _jax(name)
        b = jax_serve.ContinuousBatcher(jm, params, n_slots=4, read_chunk=2,
                                        prefill_chunk=16, prefill_rows=2)
        try:
            handles = []
            for p in inputs()["prompts"]:
                handles.append(b.submit(p, NEW))
                handles[-1].tokens.get(timeout=300)
            _STATE[key] = [h.result(timeout=300) for h in handles]
        finally:
            b.stop()
    return _STATE[key]


def _jax_engine(label):
    """The JAX batcher's outputs on the extras config's engine ``label``
    (``torch_tp_serving_ranks.extra_cases``: the same arguments, prompts,
    row options and adapters, driven the same way)."""
    key = ("engine", label)
    if key not in _STATE:
        jm, params = _jax(EXTRAS_CONFIG)
        prompts, kws, ads, kw = ranks_mod.extra_cases(inputs())[label]
        b = jax_serve.ContinuousBatcher(jm, params,
                                        **dict(ranks_mod.ENGINE, **kw))
        try:
            for name, tree in ads.items():
                b.register_adapter(name, tree)
            _STATE[key] = ranks_mod.drive(b, prompts, kws)
        finally:
            b.stop()
    return _STATE[key]


def _jax_qtree(name, mode):
    """The JAX ``quantize_tree`` of config ``name``'s whole tree."""
    key = ("qtree", name, mode)
    if key not in _STATE:
        _STATE[key] = jax_quantize.quantize_tree(
            _jax(name)[1], mode=mode, min_elements=ranks_mod.QUANT_MIN,
            group_size=ranks_mod.QUANT_GROUPS[name])
    return _STATE[key]


def _jax_quant_batcher(name, mode):
    """The JAX batcher's outputs on the unsharded quantised tree, driven
    as ``_jax_batcher``.  Its ``QuantDense`` dequantises inline
    (``quant_matmul_impl="dequant"``): the JAX package's own path for
    quantised weights under a mesh, and one a test can afford (the
    Pallas kernels' interpreter takes up to ~100 s a batcher here)."""
    key = ("qbatcher", name, mode)
    if key not in _STATE:
        jm = jax_tf.Transformer(jax_tf.TransformerConfig(
            **dict(CFGS[name], quant_matmul_impl="dequant")))
        b = jax_serve.ContinuousBatcher(jm, _jax_qtree(name, mode),
                                        **ranks_mod.ENGINE)
        try:
            _STATE[key] = ranks_mod.drive(b, inputs()["prompts"])
        finally:
            b.stop()
    return _STATE[key]


def _want_slice(name, path, q, scale, tp, index):
    """The rank's slice of a whole quantised leaf, by the float weight's
    rule."""
    cfg = CFGS[name]
    proj = path.split("/")[-2]

    def block(n):
        return slice(index * n, (index + 1) * n)

    if proj in ("out", "wo"):              # row-parallel: K
        return (q[block(q.shape[0] // tp)],
                scale if scale.shape[0] == 1
                else scale[block(scale.shape[0] // tp)])
    if proj in ("key", "value") and cfg["n_kv_heads"] % tp:
        # the kv heads this rank's q heads read, whole
        hd = cfg["d_model"] // cfg["n_heads"]
        n_q = cfg["n_heads"] // tp
        group = cfg["n_heads"] // cfg["n_kv_heads"]
        heads = [(index * n_q + i) // group for i in range(n_q)]
        cols = slice(heads[0] * hd, (heads[-1] + 1) * hd)
        return q[:, cols], scale[:, cols]
    cols = block(q.shape[1] // tp)          # column-parallel: N
    return q[:, cols], scale[:, cols]


def _noiseless(label):
    """The rows of engine ``label`` that draw no sampling noise."""
    rows = ranks_mod.extra_cases(inputs())[label][1]
    return [i for i, kw in enumerate(rows) if not kw.get("temperature")]


def _tp1(worlds, name):
    """The port's results at tp 1 on config ``name`` (the first world's
    ranks ran them, a share of the configs each)."""
    (res,) = [r["tp1"][name] for r in worlds[WORLDS[0]]
              if name in r.get("tp1", {})]
    return res


def _leader(ranks):
    (lead,) = [r for r in ranks if r["leader"]]
    return lead


TP_CFG = [(n, c) for n in WORLDS for c in CFGS]


@pytest.mark.parametrize("tp,name", TP_CFG)
def test_cache_holds_the_ranks_kv_heads(worlds, tp, name):
    cfg = CFGS[name]
    n_q = cfg["n_heads"] // tp
    group = cfg["n_heads"] // cfg["n_kv_heads"]
    for r in worlds[tp]:
        # the kv heads this rank's q heads read, each once
        want = len({(r["tp_index"] * n_q + i) // group for i in range(n_q)})
        assert r["configs"][name]["cache_heads"] == want, r["rank"]


@pytest.mark.parametrize("tp,name", TP_CFG)
def test_greedy_generate_equals_jax(worlds, tp, name):
    want, _ = _jax_generate(name)
    for r in worlds[tp]:
        assert r["configs"][name]["greedy"] == want, r["rank"]


@pytest.mark.parametrize("tp,name", TP_CFG)
def test_first_step_logits_equal_the_jax_forward(worlds, tp, name):
    _, want = _jax_generate(name)
    for r in worlds[tp]:
        np.testing.assert_allclose(r["configs"][name]["first_logits"], want,
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("tp,name", TP_CFG)
def test_sampled_generate_is_one_on_every_rank_and_tp1(worlds, tp, name):
    ranks = worlds[tp]
    got = [r["configs"][name]["sampled"] for r in ranks]
    assert all(g == got[0] for g in got)
    assert got[0] == _tp1(worlds, name)["sampled"]
    assert got[0] != _tp1(worlds, name)["greedy"]   # it did sample


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("tp,name", TP_CFG)
def test_batcher_equals_the_jax_batcher(worlds, tp, name, variant):
    outs, stats = _leader(worlds[tp])["configs"][name]["engines"][variant]
    assert outs == _jax_batcher(name)
    assert stats["tp_size"] == tp
    # one header a device operation: at least a step a token
    assert stats["tp_headers"] >= stats["decode_steps"] > 0
    if variant.startswith("paged"):
        # every rank's pool holds the kv heads its cache does
        per_head = {r["configs"][name]["engines"][variant][1][
            "kv_pool_bytes"] / r["configs"][name]["cache_heads"]
            for r in worlds[tp]}
        assert len(per_head) == 1


@pytest.mark.parametrize("tp", WORLDS)
def test_int8_prefix_grow_and_lane_equal_tp1(worlds, tp):
    ranks = worlds[tp]
    outs, st = _leader(ranks)["configs"][EXTRAS_CONFIG]["extras"]
    ref, ref_st = _tp1(worlds, EXTRAS_CONFIG)["extras"]
    assert outs == ref
    want = _jax_engine("extras")
    for i in _noiseless("extras"):
        assert outs[i] == want[i], i
    assert st["kv_dtype"] == "int8"
    assert st["prefix_hits"] > 0 and st["kv_table_grows"] > 0
    assert st["long_chunks_dispatched"] > 0
    for key in ("prefix_hits", "kv_table_grows", "long_chunks_dispatched",
                "prefill_dispatches"):
        assert st[key] == ref_st[key], key


@pytest.mark.parametrize("tp", WORLDS)
def test_dense_int8_sampled_and_penalised_rows_equal_tp1(worlds, tp):
    ranks = worlds[tp]
    outs, st = _leader(ranks)["configs"][EXTRAS_CONFIG]["dense_int8"]
    ref, _ = _tp1(worlds, EXTRAS_CONFIG)["dense_int8"]
    assert outs == ref and st["kv_dtype"] == "int8"
    want = _jax_engine("dense_int8")
    for i in _noiseless("dense_int8"):
        assert outs[i] == want[i], i
    # the sampled row did sample
    assert outs[1] != _leader(ranks)["configs"][EXTRAS_CONFIG]["engines"][
        "dense_serial"][0][1]


@pytest.mark.parametrize("tp", WORLDS)
def test_lora_rows_equal_tp1(worlds, tp):
    ranks = worlds[tp]
    outs, st = _leader(ranks)["configs"][EXTRAS_CONFIG]["lora"]
    ref, _ = _tp1(worlds, EXTRAS_CONFIG)["lora"]
    assert outs == ref
    assert outs == _jax_engine("lora")
    assert st["lora_adapters"] == ["a", "b"]
    # the adapters move the tokens (the base row and the adapted rows of
    # the same prompt differ)
    assert outs[3] != _tp1(worlds, EXTRAS_CONFIG)["engines"][
        "paged_async"][0][0]


@pytest.mark.parametrize("tp", WORLDS)
def test_out_only_adapter_moves_the_logits_as_at_tp1(worlds, tp):
    ref = _tp1(worlds, EXTRAS_CONFIG)["out_only"]
    assert np.abs(ref["out_only"] - ref["base"]).max() > 1e-2
    for r in worlds[tp]:
        got = r["configs"][EXTRAS_CONFIG]["out_only"]
        for label in ("base", "out_only"):
            np.testing.assert_allclose(got[label], ref[label],
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("feature", REFUSED)
@pytest.mark.parametrize("tp", WORLDS)
def test_queued_features_raise_naming_a3c(worlds, tp, feature):
    for r in worlds[tp]:
        kind, text = r["refusals"][feature]
        assert kind == "NotImplementedError", (feature, text)
        assert "ROADMAP A3c" in text, text


@pytest.mark.parametrize("tp", WORLDS)
def test_mismatched_engines_raise_on_every_rank(worlds, tp):
    for r in worlds[tp]:
        kind, text = r["refusals"]["mismatch"]
        assert kind == "ValueError" and "n_slots" in text, text
        kind, text = r["refusals"]["no_mesh"]
        assert kind == "ValueError" and "use_mesh" in text, text


QUANT = [(tp, name, mode) for tp in WORLDS for name in ranks_mod.QUANT_GROUPS
         for mode in QUANT_MODES]


@pytest.mark.parametrize("tp,name,mode", QUANT)
def test_quantised_leaves_are_the_jax_trees_sliced(worlds, tp, name, mode):
    flat = {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                _jax_qtree(name, mode),
                is_leaf=jax_quantize.is_quantized_leaf)[0]
            if jax_quantize.is_quantized_leaf(leaf)}
    # every projection of every layer and the head
    assert len(flat) == 6 * CFGS[name]["n_layers"] + 1
    for r in worlds[tp]:
        leaves = r["configs"][name]["quant"][mode]["leaves"]
        assert len(leaves) == 2 * len(flat)
        for port_name in {n.rsplit(".", 1)[0] for n in leaves}:
            path = port_name.replace(".", "/") + "/kernel"
            leaf = flat["".join(f"['{k}']" for k in path.split("/"))]
            if mode == "int8":
                q, scale = leaf["q"], leaf["scale"]
            else:
                q, scale = leaf.q, leaf.scale
            want_q, want_s = _want_slice(name, path, np.asarray(q),
                                         np.asarray(scale), tp,
                                         r["tp_index"])
            got_q, got_s = (leaves[port_name + ".q"],
                            leaves[port_name + ".scale"])
            assert got_q.dtype == np.int8 and got_s.dtype == np.float32
            np.testing.assert_array_equal(got_q, want_q, err_msg=path)
            np.testing.assert_array_equal(got_s, want_s, err_msg=path)


@pytest.mark.parametrize("tp,name,mode", QUANT)
def test_quantised_tokens_equal_the_jax_batcher(worlds, tp, name, mode):
    want = _jax_quant_batcher(name, mode)
    for r in worlds[tp]:
        assert r["configs"][name]["quant"][mode]["generate"] == want[0], \
            r["rank"]
    engines = _leader(worlds[tp])["configs"][name]["quant"][mode]["engines"]
    for variant in ranks_mod.QUANT_VARIANTS:
        outs, st = engines[variant]
        assert outs == want, variant
        assert f"{mode}_matmul" in st["kernel_launches"]


@pytest.mark.parametrize("tp", WORLDS)
def test_stored_int8_export_serves_on_the_mesh(worlds, tp):
    outs, st = _leader(worlds[tp])["configs"]["gqa8"]["quant"]["stored_int8"]
    assert outs == _jax_quant_batcher("gqa8", "int8")
    assert "int8_matmul" in st["kernel_launches"]


@pytest.mark.parametrize("tp", WORLDS)
def test_straddling_int4_group_raises_naming_a3c(worlds, tp):
    for r in worlds[tp]:
        kind, text = r["refusals"]["int4_straddle"]
        assert kind == "NotImplementedError", text
        assert "ROADMAP A3c" in text and "straddles" in text, text


def _jax_greedy(prompt):
    """JAX ``generate``'s greedy tokens of one prompt on the extras
    config."""
    key = ("greedy", tuple(prompt))
    if key not in _STATE:
        jm, params = _jax(EXTRAS_CONFIG)
        _STATE[key] = np.asarray(jax_decode.generate(
            jm, params, jnp.asarray([prompt], jnp.int32),
            max_new_tokens=NEW))[0].tolist()
    return _STATE[key]


@pytest.mark.parametrize("label", tuple(ranks_mod.SPEC_ENGINES))
@pytest.mark.parametrize("tp", WORLDS)
def test_speculation_equals_tp1_and_jax_greedy(worlds, tp, label):
    """Greedy speculation commits the target's own greedy tokens: the
    greedy rows are held to JAX ``generate``'s.  (The JAX batcher's draft
    engine breaks that promise on the third row, a prefix-cache hit: it
    gives other tokens than its own ``generate``; ROADMAP C.)"""
    ranks = worlds[tp]
    outs, st = _leader(ranks)["configs"][EXTRAS_CONFIG][label]
    ref, ref_st = _tp1(worlds, EXTRAS_CONFIG)[label]
    assert outs == ref
    prompts = ranks_mod.extra_cases(inputs())[label][0]
    for i in _noiseless(label):
        assert outs[i] == _jax_greedy(prompts[i]), i
    assert st["spec_rounds"] > 0 and st["spec_mode"] == (
        "ngram" if "ngram" in label else "model")
    for r in ranks:
        got = r["configs"][EXTRAS_CONFIG][label][1]
        # a follower replays the leader's rounds at the leader's k
        assert got["spec_rounds"] == st["spec_rounds"], r["rank"]
        assert got["spec_k_mean"] == st["spec_k_mean"], r["rank"]
        if label in ranks_mod.SPEC_ONE_AT_A_TIME:
            for key in ranks_mod.SPEC_STATS:
                assert got[key] == ref_st[key], (r["rank"], key)
    if label in ranks_mod.SPEC_ONE_AT_A_TIME:
        assert ref_st["spec_tokens_accepted"] > 0
    if label == "spec_draft":
        # the third request shares the first one's prefix pages: the
        # draft caught up over them
        assert st["prefix_hits"] > 0
