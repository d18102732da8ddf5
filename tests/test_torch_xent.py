"""Parity of the port's ``fused_unembed_xent`` with the JAX package's
``ops.xent`` and with ``lm_loss``, on the CPU.

The same numpy hidden states, ``lm_head`` kernel and targets (some
``ignore_id``, a token count that leaves the last chunk padded) go
through JAX's ``fused_unembed_xent`` (its kernel ``[D, V]``) and the
port's (the port's ``[V, D]`` weight): the loss, d hidden and d kernel.
Then ``Transformer(return_hidden=True)`` with the fused loss against
``lm_loss`` of the full logits, gradients of every parameter included
(``lm_head.weight`` gets its gradient through the op).

Tolerances: loss 1e-5 relative, gradients 1e-5 absolute + 1e-4
relative (f32 on both sides, chunked sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.ops import xent as jax_xent
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.ops import xent as port_xent


def _data(seed=0, B=3, S=7, D=16, V=40):
    rng = np.random.RandomState(seed)
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    k = (0.3 * rng.standard_normal((D, V))).astype(np.float32)
    t = rng.randint(0, V, (B, S))
    t[0, :3] = -1
    t[2, -1] = -1
    return h, k, t


@pytest.mark.parametrize("chunk", [4, 8, 64])
def test_loss_and_grads_match_jax(chunk):
    h, k, t = _data()

    def jloss(hh, kk):
        return jax_xent.fused_unembed_xent(hh, kk, jnp.asarray(t), chunk)

    want, (dh, dk) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(k))
    ph = torch.from_numpy(h).requires_grad_(True)
    pw = torch.from_numpy(np.ascontiguousarray(k.T)).requires_grad_(True)
    got = port_xent.fused_unembed_xent(ph, pw, torch.from_numpy(t), chunk)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(ph.grad.numpy(), np.asarray(dh), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(pw.grad.numpy().T, np.asarray(dk),
                               atol=1e-5, rtol=1e-4)
    # and against the full-logits loss
    ref = port_tf.lm_loss(torch.einsum("bsd,vd->bsv", torch.from_numpy(h),
                                       torch.from_numpy(k.T.copy())),
                          torch.from_numpy(t))
    assert got.item() == pytest.approx(ref.item(), rel=1e-5)


def test_return_hidden_with_the_fused_loss_matches_lm_loss():
    cfg = dict(vocab_size=48, d_model=32, n_heads=2, n_layers=2, d_ff=32,
               max_seq_len=16, dtype="float32", rope=True,
               norm_type="rmsnorm")
    torch.manual_seed(0)
    model = port_tf.build_transformer(**cfg)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 48,
                                                               (2, 13)))
    ref = port_tf.lm_loss(model(tokens[:, :-1]), tokens[:, 1:])
    ref_grads = torch.autograd.grad(ref, list(model.parameters()))
    h = model(tokens[:, :-1], return_hidden=True)
    assert h.shape == (2, 12, 32)
    got = port_xent.fused_unembed_xent(h, model.lm_head.weight,
                                       tokens[:, 1:], chunk_size=5)
    grads = torch.autograd.grad(got, list(model.parameters()))
    assert got.item() == pytest.approx(ref.item(), rel=1e-5)
    for (name, _), g, r in zip(model.named_parameters(), grads, ref_grads):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-4, msg=name)
