"""The port's ``lora`` against the JAX package's, on the same arrays.

A tiny f32 LM, seeded, in both packages' layouts
(``convert.params_to_jax``).  Tolerances: f32 on both sides.

- ``target_paths`` and ``init``'s selection and shapes equal JAX's (the
  default attention targets and a custom MLP pattern);
- ``merge`` equals JAX ``merge`` leaf for leaf (1e-6);
- a zero ``b`` gives the base model's logits exactly;
- ``make_lora_loss``'s gradient with respect to the adapters equals
  JAX's ``jax.grad`` of its lora loss (1e-5 relative), and training with
  ``parallel.train.make_train_step`` (adamw_fused, kernel 7's plain
  version) moves only the adapters, lowers the loss and sizes the
  optimizer state to the adapters;
- the adapter file is byte-equal to JAX ``save_adapters`` of the same
  arrays, and each package reads the other's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import lora as jax_lora
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert, lora, optim
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.parallel import train as port_train

CFG = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq_len=32, dtype="float32", attention_impl="dense")


@pytest.fixture(scope="module")
def base():
    pm = port_tf.build_transformer(**CFG)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**CFG))
    return jm, convert.params_to_jax(pm.state_dict()), pm.eval()


def _adapters(params, seed, rank=4, **kw):
    """JAX adapters with a random b (numpy) and the port's copy."""
    ad = jax_lora.init(jax.random.key(seed), params, rank=rank, **kw)
    rs = np.random.RandomState(seed)
    ad = {k: {"a": np.asarray(v["a"]),
              "b": rs.randn(*v["b"].shape).astype(np.float32) * 0.1}
          for k, v in ad.items()}
    port = {k: {n: torch.from_numpy(x.copy()) for n, x in v.items()}
            for k, v in ad.items()}
    return ad, port


def test_targets_and_init_match_jax(base):
    _, params, pm = base
    assert lora.target_paths(pm) == jax_lora.target_paths(params)
    for targets in (jax_lora.DEFAULT_TARGETS, r"mlp/(wi|wo)/kernel$"):
        want = jax_lora.init(jax.random.key(1), params, rank=2,
                             targets=targets)
        got = lora.init(torch.Generator().manual_seed(1), pm, rank=2,
                        targets=targets)
        assert list(got) == sorted(want)
        for k in want:
            assert tuple(got[k]["a"].shape) == want[k]["a"].shape
            assert tuple(got[k]["b"].shape) == want[k]["b"].shape
            assert not got[k]["b"].any()
        assert lora.num_trainable(got) == jax_lora.num_trainable(want)
    with pytest.raises(ValueError):
        lora.init(torch.Generator(), pm, targets="nonexistent/kernel$")


def test_merge_equals_jax_merge(base):
    _, params, pm = base
    ad, port = _adapters(params, 2)
    want = convert.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_lora.merge(params, ad, scale=0.5)))
    got = lora.merge(pm.state_dict(), port, scale=0.5)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match="adapter paths not found"):
        lora.merge(pm.state_dict(), {"encoder/" + k: v
                                     for k, v in port.items()})


def test_zero_b_starts_at_base_model(base):
    _, _, pm = base
    adapters = lora.init(torch.Generator().manual_seed(1), pm, rank=4)
    tuned = port_tf.build_transformer(**CFG).eval()
    tuned.load_state_dict(lora.merge(pm.state_dict(), adapters))
    x = torch.from_numpy(np.random.RandomState(0).randint(0, 61, (2, 16)))
    with torch.no_grad():
        assert torch.equal(tuned(x), pm(x))


def _loss(m, batch, rng):
    return port_tf.lm_loss(m(batch[:, :-1]), batch[:, 1:])


def test_lora_gradient_matches_jax_and_training_moves_only_adapters(base):
    jm, params, pm = base
    model = port_tf.build_transformer(**CFG)
    model.load_state_dict(pm.state_dict())
    before = {n: t.clone() for n, t in model.state_dict().items()}
    ad, port = _adapters(params, 3)
    batch = np.random.RandomState(1).randint(0, 61, (4, 17))

    def jax_loss(p, b, rng):
        return jax_tf.lm_loss(jm.apply({"params": p}, b[:, :-1]), b[:, 1:])

    jgrad = jax.jit(jax.grad(jax_lora.make_lora_loss(jax_loss, params,
                                                     2.0)))(
        jax.tree_util.tree_map(jnp.asarray, ad), jnp.asarray(batch),
        jax.random.key(0))
    lora_loss = lora.make_lora_loss(_loss, model, scale=2.0)
    flat = {k: t.requires_grad_(True) for k, t in lora.flatten(port).items()}
    grads = torch.autograd.grad(lora_loss(flat, torch.from_numpy(batch),
                                          None), list(flat.values()))
    for (key, g) in zip(flat, grads):
        path, leaf = key.rsplit("/", 1)
        want = np.asarray(jgrad[path][leaf])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=key)

    opt, _ = optim.make_optimizer("adamw_fused", learning_rate=1e-2)
    adapters = lora.flatten(lora.init(torch.Generator().manual_seed(1),
                                      model, rank=4))
    state = port_train.create_train_state(adapters, opt)
    step = port_train.make_train_step(lora_loss, opt, donate=False)
    tokens = torch.from_numpy(batch)
    losses = []
    for _ in range(4):
        state, m = step(state, tokens, None)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert any(t.abs().max() > 0 for k, t in state.params.items()
               if k.endswith("/b"))
    assert set(state.opt_state.mu) == set(adapters)   # sized to adapters
    for n, t in model.state_dict().items():         # the base is constant
        assert torch.equal(t, before[n]), n
    assert not any(p.requires_grad for p in model.parameters())


def test_adapter_file_is_byte_equal_to_jax(base, tmp_path):
    _, params, _ = base
    ad, port = _adapters(params, 4)
    jpath, ppath = str(tmp_path / "j.msgpack"), str(tmp_path / "p.msgpack")
    jax_lora.save_adapters(jpath, ad, scale=0.5)
    lora.save_adapters(ppath, port, scale=0.5)
    with open(jpath, "rb") as f, open(ppath, "rb") as g:
        assert f.read() == g.read()
    got, scale = lora.load_adapters(jpath)
    assert scale == 0.5 and sorted(got) == sorted(ad)
    for k in ad:
        for leaf in ("a", "b"):
            assert np.array_equal(got[k][leaf].numpy(), ad[k][leaf])
    back, jscale = jax_lora.load_adapters(ppath)
    assert jscale == 0.5 and sorted(back) == sorted(ad)
    with pytest.raises(ValueError, match="empty"):
        lora.save_adapters(ppath, {})
