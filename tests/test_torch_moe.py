"""Parity of the port's MoE layers with the JAX package's, on the CPU.

The same numpy inputs and weights go through the JAX ``MoEMLP`` /
``Transformer`` (f32) and the port's (f32, CPU), the weights carried by
``convert`` (the JAX tree's structure from ``jax.eval_shape``, filled
with seeded numpy draws):

- the routing indices first: the port's ``expert_index`` equals
  ``lax.top_k`` of the JAX router's probabilities, ties to the lower
  index included (a zero router makes every probability equal);
- the dense router; top-k at full capacity equal to dense (as the JAX
  package's own test checks); top-k k=2 at capacity 0.25 with drops;
  gated experts; the aux loss against the value JAX sows;
- the ValueErrors of a bad router and a bad k, and the splits a mesh
  would make of the experts raising NotImplementedError naming A3c;
- a MoE Transformer's logits and gradients.

Tolerances: outputs max |diff| <= 1e-4 * max(1, max |ref|); the aux
loss 1e-5 relative (f32 on both sides, other summation orders).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.parallel import mesh as mesh_mod
from tensorflowonspark_tpu_torch.parallel import sharding as port_sharding

BASE = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=24,
            max_seq_len=16, dtype="float32", num_experts=4, moe_every=1)


def _close(got, want, what=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol, what


def _fill(shapes, seed, scale=0.5):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: scale * rng.standard_normal(s.shape).astype(np.float32),
        shapes)


def _moe_pair(seed, **over):
    """``(jax MoEMLP, its params, port MoEMLP loaded with them, x)``."""
    kw = dict(BASE, **over)
    x = np.random.RandomState(seed).standard_normal((2, 8, 16)).astype(
        np.float32)
    jm = jax_tf.MoEMLP(jax_tf.TransformerConfig(**kw))
    params = _fill(jax.eval_shape(jm.init, jax.random.key(0), x)["params"],
                   seed)
    pm = port_tf.MoEMLP(port_tf.TransformerConfig(**kw))
    pm.load_state_dict(convert.params_from_jax(params), strict=True)
    return jm, params, pm, x


def _jax_run(jm, params, x):
    y, state = jm.apply({"params": params}, x, mutable=["intermediates"])
    return y, float(state["intermediates"]["moe_aux_loss"][0])


def _jax_topk(params, x, k):
    probs = jax.nn.softmax(jnp.asarray(x) @ params["router"]["kernel"], -1)
    return np.asarray(jax.lax.top_k(probs.reshape(-1, probs.shape[-1]),
                                    k)[1])


@pytest.mark.parametrize("router,k,factor,style", [
    ("dense", 1, 1.25, "plain"),
    ("topk", 1, 1.25, "plain"),
    ("topk", 2, 0.25, "plain"),            # drops
    ("topk", 2, 1.25, "gated"),
    ("dense", 1, 1.25, "gated")])
def test_moe_layer_matches_jax(router, k, factor, style):
    jm, params, pm, x = _moe_pair(
        1, moe_router=router, moe_top_k=k, moe_capacity_factor=factor,
        mlp_style=style, activation="silu" if style == "gated"
        else "gelu_tanh")
    want, aux = _jax_run(jm, params, x)
    got = pm(torch.from_numpy(x))
    # the routing first, then what it computes
    np.testing.assert_array_equal(
        pm.expert_index.reshape(-1, k).numpy(), _jax_topk(params, x, k))
    _close(got, want, router)
    assert pm.aux_loss.item() == pytest.approx(aux, rel=1e-5)
    assert pm.dropped.item() == pytest.approx(
        0.0 if router == "dense" else _dropped(_jax_topk(params, x, k), 4,
                                               factor))
    if factor < 1:
        assert pm.dropped.item() > 0


def _dropped(idx, E, factor):
    """The share of token-expert assignments past capacity, token by
    token in JAX's order (every first choice before any second one)."""
    T, k = idx.shape
    C = min(int(max(1, -(-factor * k * T // E))), T)
    counts = np.zeros(E, int)
    kept = 0
    for c in range(k):
        for t in range(T):
            kept += counts[idx[t, c]] < C
            counts[idx[t, c]] += 1
    return 1.0 - kept / (T * k)


def test_ties_route_to_the_lower_index_as_lax_top_k():
    jm, params, pm, x = _moe_pair(2, moe_router="topk", moe_top_k=2,
                                  moe_capacity_factor=1.0)
    params["router"]["kernel"] = np.zeros_like(params["router"]["kernel"])
    with torch.no_grad():
        pm.router.weight.zero_()
    want, aux = _jax_run(jm, params, x)
    got = pm(torch.from_numpy(x))
    idx = pm.expert_index.reshape(-1, 2).numpy()
    np.testing.assert_array_equal(idx, _jax_topk(params, x, 2))
    assert (idx == [0, 1]).all()
    # 16 tokens, 2 experts chosen, 8 slots each: half the tokens dropped
    assert pm.dropped.item() == pytest.approx(0.5)
    _close(got, want)
    assert pm.aux_loss.item() == pytest.approx(aux, rel=1e-5)


def _model_pair(seed, **over):
    kw = dict(BASE, **over)
    tokens = np.random.RandomState(seed).randint(0, 32, (2, 9))
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**kw))
    params = _fill(jax.eval_shape(jm.init, jax.random.key(0),
                                  tokens)["params"], seed, 0.3)
    pm = port_tf.build_transformer(**kw)
    pm.load_state_dict(convert.params_from_jax(params), strict=True)
    return jm, params, pm, tokens


def test_topk_full_capacity_equals_dense_router():
    jm, params, pm, tokens = _model_pair(3)
    dense = pm(torch.from_numpy(tokens))
    _close(dense, jm.apply({"params": params}, tokens))
    topk = port_tf.build_transformer(**dict(
        BASE, moe_router="topk", moe_top_k=1, moe_capacity_factor=4.0))
    topk.load_state_dict(pm.state_dict())
    got = topk(torch.from_numpy(tokens))
    # C = 4 T / E = T: nothing dropped, the same experts
    assert all(m.dropped.item() == 0 for m in topk.moe_layers().values())
    torch.testing.assert_close(got, dense, atol=2e-5, rtol=2e-5)


def test_moe_transformer_logits_and_grads_match_jax():
    over = dict(moe_every=2, n_layers=4, moe_router="topk", moe_top_k=2,
                moe_capacity_factor=0.5)
    jm, params, pm, tokens = _model_pair(4, **over)
    assert list(pm.moe_layers()) == ["layer_1", "layer_3"]

    def jax_loss(p):
        return jax_tf.lm_loss(jm.apply({"params": p}, tokens[:, :-1]),
                              tokens[:, 1:])

    want, grads = jax.value_and_grad(jax_loss)(params)
    t = torch.from_numpy(tokens)
    loss = port_tf.lm_loss(pm(t[:, :-1]), t[:, 1:])
    loss.backward()
    assert loss.item() == pytest.approx(float(want), rel=1e-5)
    got = convert.params_to_jax({n: p.grad for n, p in
                                 pm.named_parameters()})
    flat = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        np.testing.assert_allclose(g, np.asarray(flat[path]), atol=2e-5,
                                   rtol=1e-4, err_msg=str(path))


def test_bad_router_and_k_raise_value_errors():
    for over, frag in (({"moe_router": "sorted"}, "moe_router"),
                       ({"moe_router": "topk", "moe_top_k": 9},
                        "moe_top_k"),
                       ({"moe_router": "topk", "moe_top_k": 0},
                        "moe_top_k")):
        cfg = dict(BASE, **over)
        with pytest.raises(ValueError, match=frag):
            port_tf.build_transformer(**cfg)
        with pytest.raises(ValueError, match=frag):
            jax_tf.Transformer(jax_tf.TransformerConfig(**cfg)).init(
                jax.random.key(0), jnp.zeros((1, 4), jnp.int32))


@pytest.mark.parametrize("spec", [dict(dp=4), dict(tp=2), dict(fsdp=2)])
def test_a_mesh_that_splits_the_experts_raises_naming_a3c(spec):
    model = port_tf.build_transformer(**BASE)
    mesh = mesh_mod.Mesh(mesh_mod.MeshSpec(**spec).resolve(
        int(np.prod(list(spec.values())))))
    with pytest.raises(NotImplementedError, match="ROADMAP A3c"):
        shardings = port_sharding.infer_param_shardings(
            model, mesh, fsdp="fsdp" in spec)
        port_sharding.shard_params(model, shardings)
    # one card runs it whole
    assert model(torch.zeros((1, 4), dtype=torch.long)).shape == (1, 4, 32)


def test_expert_leaves_keep_their_flax_path_and_the_jax_specs():
    """``experts_wi/kernel`` is one flax name holding a "/": the port's
    ``experts_wi`` maps back to it, so the JAX expert rules match."""
    from tensorflowonspark_tpu.parallel import sharding as jax_sharding

    model = port_tf.build_transformer(**dict(BASE, mlp_style="gated"))
    for name, t in model.named_parameters():
        path, _ = convert.flax_path(name, t.dim())
        assert port_sharding.spec_for_path(path) == tuple(
            jax_sharding.spec_for_path(path)), path
    assert convert.flax_path("layer_0.moe.experts_up", 3)[0] == \
        "layer_0/moe/experts_up/kernel"
    assert port_sharding.spec_for_path("layer_0/moe/experts_wo/kernel") == \
        ("dp", "tp", None)
