"""The zoo and MoE slice as a whole, against the JAX package, on the CPU.

- Two ``make_train_step`` steps with ``adamw`` (optax's semantics: the
  port's plain PyTorch version, JAX's jitted optax; clipping and weight
  decay on) for a ResNet, a ViT, a BERT (MLM + NSP) and a tiny MoE LM
  (top-2 routing with drops) from the same weights (the port's seeded
  draw, carried to JAX by ``convert``) and the same numpy batches: the
  loss and the grad norm of each step within 1e-5 relative (f32 on both
  sides, summation orders differ).  The fused AdamW of the card's path
  is held to JAX's in ``tests/test_torch_train.py``; JAX runs it in
  Pallas interpret mode, which compiles for about ten seconds a model.
- A tiny MoE LM exported by the JAX package (its builder spec and
  ``params.msgpack``), read by the port's ``export.load_model`` through
  ``convert.port_builder``, and greedy-decoded by the port's paged
  ``ContinuousBatcher``: every token equal to the JAX paged batcher's
  over the same export (f32; the top-k capacity of each call counts the
  rows JAX routes, free slots included).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import export as jax_export
from tensorflowonspark_tpu import optim as jax_optim
from tensorflowonspark_tpu import serve as jax_serve
from tensorflowonspark_tpu.models import bert as jax_bert
from tensorflowonspark_tpu.models import mlp as jax_mlp
from tensorflowonspark_tpu.models import resnet as jax_resnet
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu.models import vit as jax_vit
from tensorflowonspark_tpu.parallel import train as jax_train
from tensorflowonspark_tpu_torch import convert, export, serve
from tensorflowonspark_tpu_torch import optim as port_optim
from tensorflowonspark_tpu_torch.models import bert as port_bert
from tensorflowonspark_tpu_torch.models import mlp as port_mlp
from tensorflowonspark_tpu_torch.models import resnet as port_resnet
from tensorflowonspark_tpu_torch.models import transformer as port_tf
from tensorflowonspark_tpu_torch.models import vit as port_vit
from tensorflowonspark_tpu_torch.parallel import train as port_train

OPT_NAME = "adamw"
OPT = dict(learning_rate=1e-2, weight_decay=0.1, clip_norm=0.5)
MOE = dict(vocab_size=48, d_model=32, n_heads=2, n_layers=2, d_ff=32,
           max_seq_len=64, dtype="float32", rope=True, num_experts=4,
           moe_every=2, moe_router="topk", moe_top_k=2,
           moe_capacity_factor=1.25)
_RESNET = dict(stage_sizes=(1, 1), num_filters=8, num_classes=5,
               dtype="float32")
_VIT = dict(image_size=16, patch_size=4, num_classes=5, d_model=32,
            n_heads=2, n_layers=2, d_ff=64, dtype="float32")
_BERT = dict(vocab_size=40, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_seq_len=16, dtype="float32")


def _case(name):
    """``(port model, jax module, port loss, jax loss, numpy batch)``."""
    rng = np.random.RandomState(5)
    torch.manual_seed(7)
    if name in ("resnet", "vit"):
        imgs = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
        batch = (imgs, rng.randint(0, 5, (4,)))
        if name == "resnet":
            pm = port_resnet.ResNet(**_RESNET)
            jm = jax_resnet.ResNet(**_RESNET)
        else:
            pm = port_vit.ViT(port_vit.ViTConfig(**_VIT))
            jm = jax_vit.ViT(jax_vit.ViTConfig(**_VIT))

        def pl(m, b, r):
            return port_mlp.cross_entropy_loss(m(b[0]), b[1])

        def jl(p, b, r):
            return jax_mlp.cross_entropy_loss(jm.apply({"params": p}, b[0]),
                                              b[1])
    elif name == "bert":
        tokens = rng.randint(0, 40, (3, 12))
        corrupted, targets = port_bert.apply_mlm_masking(1, tokens, 3, 40)
        batch = (corrupted, targets, rng.randint(0, 2, (3,)))
        pm = port_bert.BertForPreTraining(port_bert.BertConfig(**_BERT))
        jm = jax_bert.BertForPreTraining(jax_bert.BertConfig(**_BERT))

        def pl(m, b, r):
            mlm, nsp = m(b[0])
            return port_bert.mlm_loss(mlm, b[1]) + port_bert.nsp_loss(nsp,
                                                                      b[2])

        def jl(p, b, r):
            mlm, nsp = jm.apply({"params": p}, b[0])
            return jax_bert.mlm_loss(mlm, b[1]) + jax_bert.nsp_loss(nsp,
                                                                    b[2])
    else:
        batch = rng.randint(0, 48, (4, 17))
        pm = port_tf.build_transformer(**MOE)
        pm.reset_parameters(torch.Generator().manual_seed(3))
        jm = jax_tf.Transformer(jax_tf.TransformerConfig(**MOE))

        def pl(m, b, r):
            return port_tf.lm_loss(m(b[:, :-1]), b[:, 1:])

        def jl(p, b, r):
            return jax_tf.lm_loss(jm.apply({"params": p}, b[:, :-1]),
                                  b[:, 1:])
    return pm, jm, pl, jl, batch


@pytest.mark.parametrize("name", ["resnet", "vit", "bert", "moe_lm"])
def test_two_adamw_steps_match_jax(name):
    pm, jm, pl, jl, batch = _case(name)
    params = convert.params_to_jax(pm.state_dict())
    jopt, _ = jax_optim.make_optimizer(OPT_NAME, **OPT)
    jstate = jax_train.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), jopt)
    jstep = jax_train.make_train_step(jl, jopt)
    popt, _ = port_optim.make_optimizer(OPT_NAME, **OPT)
    pstate = port_train.create_train_state(pm, popt)
    pstep = port_train.make_train_step(pl, popt)
    as_jax = jax.tree_util.tree_map(jnp.asarray, batch)
    as_port = jax.tree_util.tree_map(torch.from_numpy, batch)
    losses = []
    for _ in range(2):
        jstate, jm_ = jstep(jstate, as_jax, jax.random.key(0))
        pstate, pm_ = pstep(pstate, as_port, None)
        for key in ("loss", "grad_norm"):
            assert pm_[key].item() == pytest.approx(float(jm_[key]),
                                                    rel=1e-5), (name, key)
        losses.append(pm_["loss"].item())
    assert losses[1] != losses[0]


PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12, 13, 14, 15], [20, 21]]
ENGINE = dict(n_slots=3, read_chunk=2, prefill_chunk=16, kv_page_size=8,
              kv_pages=32)


def _decode_both(tmp_path, factor, fresh):
    """Greedy tokens of PROMPTS (8 new each, then the three at once, 6
    new) from the JAX paged batcher and the port's over one JAX export
    of the MoE LM at ``moe_capacity_factor=factor``; ``fresh``: a new
    batcher for each request, so that no free row has served before."""
    cfg = dict(MOE, moe_capacity_factor=factor)
    pm = port_tf.build_transformer(**cfg)
    pm.reset_parameters(torch.Generator().manual_seed(11))
    params = convert.params_to_jax(pm.state_dict())
    d = str(tmp_path / "moe")
    jax_export.export_saved_model(
        d, params, builder="tensorflowonspark_tpu.models.transformer:"
        "build_transformer", builder_kwargs=cfg)
    model, spec = export.load_model(d, device="cpu")
    assert model.moe_layers() and spec["builder"].startswith(
        "tensorflowonspark_tpu.")
    model.eval().requires_grad_(False)
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**cfg))
    runs = {}
    for side, make in (
            ("jax", lambda: jax_serve.ContinuousBatcher(jm, params,
                                                        **ENGINE)),
            ("port", lambda: serve.ContinuousBatcher(model, device="cpu",
                                                     **ENGINE))):
        batches = ([[p] for p in PROMPTS] if fresh else [PROMPTS])
        out = []
        for group in batches:
            b = make()
            try:
                out += [b.submit(p, 8).result(timeout=300) for p in group]
            finally:
                b.stop()
        b = make()
        try:
            hs = [b.submit(p, 6) for p in PROMPTS]      # three rows at once
            out += [h.result(timeout=300) for h in hs]
        finally:
            b.stop()
        runs[side] = out
    return runs


@pytest.mark.parametrize("factor,fresh", [(1.25, True), (2.0, False)],
                         ids=["drops-fresh", "no-drops-reused"])
def test_jax_moe_export_decodes_to_the_jax_batchers_tokens(tmp_path,
                                                           factor, fresh):
    """Both batchers route each call over all their rows (free slots and
    a prefill's bucket padding included), so capacity counts the same T.
    At capacity 1.25 a free row that served before decodes garbage that
    competes for slots, in the JAX batcher as in the port, and the two
    garbages need not agree: there every request gets a fresh batcher.
    At capacity 2.0 (C = T: no drops) one batcher serves them all."""
    runs = _decode_both(tmp_path, factor, fresh)
    assert runs["port"] == runs["jax"]
