"""The port's HuggingFace converters against the JAX package's and HF's.

Random tiny HF models (the configs of ``tests/test_convert.py``, built
under ``torch.manual_seed``) go through the JAX package's ``from_hf_*``
and the port's, for GPT-2, BERT (``BertModel`` and
``BertForPreTraining``), LLaMA (tied and untied) and Mixtral:

- the port's state dict equals ``convert.params_from_jax`` of the JAX
  tree bit for bit (same names, dtypes, shapes and values), and the two
  configs agree on every field they share;
- the logits of the port's model on the converted weights match the HF
  torch forward and the JAX model's apply, f32, within 1e-5 (atol and
  rtol; the logits of these tiny models are of order 1e-1, and both
  sides sum in f32 in other orders);
- every config the JAX converters refuse raises the same ValueError;
- the directory form (``save_pretrained`` into ``tmp_path``) gives the
  in-memory model's tensors; the ``(config, state_dict)`` form works
  with ``transformers`` blocked from import (a directory then raises
  ImportError naming the package);
- Mixtral's sliding-window clamp and its E/k capacity default;
- a converted LLaMA, Mixtral and GPT-2 (learned positions and biases in
  the paged path) greedy-decode through the port's paged
  ``ContinuousBatcher`` to the JAX batcher's tokens in f32 (equal).
"""
import sys

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import convert as jax_convert
from tensorflowonspark_tpu import serve as jax_serve
from tensorflowonspark_tpu.models import bert as jax_bert
from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert, serve
from tensorflowonspark_tpu_torch.models import bert as port_bert
from tensorflowonspark_tpu_torch.models import transformer as port_tf

TOL = 1e-5
ENGINE = dict(n_slots=2, read_chunk=2, prefill_chunk=16, kv_page_size=8,
              kv_pages=40)


def _gpt2(tie=True, seed=0, **kw):
    cfg = transformers.GPT2Config(
        vocab_size=97, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
        tie_word_embeddings=tie, **kw)
    torch.manual_seed(seed)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _bert_cfg(**kw):
    return transformers.BertConfig(**dict(dict(
        vocab_size=120, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=48, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0), **kw))


def _llama(tie=False, seed=0):
    cfg = transformers.LlamaConfig(
        vocab_size=97, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-6, rope_theta=10000.0,
        attention_bias=False, tie_word_embeddings=tie,
        attention_dropout=0.0)
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(cfg).eval()


def _mixtral(seed=0):
    cfg = transformers.MixtralConfig(
        vocab_size=97, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, rms_norm_eps=1e-6,
        tie_word_embeddings=False, attention_dropout=0.0,
        sliding_window=None)
    torch.manual_seed(seed)
    return transformers.MixtralForCausalLM(cfg).eval()


# name -> (hf model factory, jax converter, port converter, kind)
FAMILIES = {
    "gpt2": (_gpt2, jax_convert.from_hf_gpt2, convert.from_hf_gpt2, "lm"),
    "gpt2_untied": (lambda: _gpt2(tie=False, seed=1),
                    jax_convert.from_hf_gpt2, convert.from_hf_gpt2, "lm"),
    "bert_model": (lambda: (torch.manual_seed(0), transformers.BertModel(
                       _bert_cfg(), add_pooling_layer=False).eval())[1],
                   jax_convert.from_hf_bert, convert.from_hf_bert,
                   "encoder"),
    "bert_pretraining": (
        lambda: (torch.manual_seed(1), transformers.BertForPreTraining(
            _bert_cfg()).eval())[1],
        jax_convert.from_hf_bert, convert.from_hf_bert, "pretraining"),
    "llama": (_llama, jax_convert.from_hf_llama, convert.from_hf_llama,
              "lm"),
    "llama_tied": (lambda: _llama(tie=True, seed=1),
                   jax_convert.from_hf_llama, convert.from_hf_llama, "lm"),
    "mixtral": (_mixtral, jax_convert.from_hf_mixtral,
                convert.from_hf_mixtral, "lm"),
}


@pytest.fixture(scope="module")
def hf_models():
    return {name: spec[0]() for name, spec in FAMILIES.items()}


def _port_model(kind, cfg, sd):
    if kind == "lm":
        model = port_tf.Transformer(cfg)
    elif kind == "encoder":
        model = port_bert.BertEncoder(cfg)
    else:
        model = port_bert.BertForPreTraining(cfg)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _jax_model(kind, cfg):
    if kind == "lm":
        return jax_tf.Transformer(cfg)
    if kind == "encoder":
        return jax_bert.BertEncoder(cfg)
    return jax_bert.BertForPreTraining(cfg)


def _tokens(name, vocab):
    return np.random.RandomState(len(name)).randint(0, vocab, (2, 12))


def _assert_same_tensors(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", list(FAMILIES))
def test_tensors_equal_the_jax_tree_and_configs_agree(name, hf_models):
    _, jconv, pconv, _ = FAMILIES[name]
    jcfg, jparams = jconv(hf_models[name], attention_impl="dense")
    pcfg, sd = pconv(hf_models[name], attention_impl="dense")
    _assert_same_tensors(sd, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    for t in sd.values():
        assert t.is_contiguous()
    # the port's master copies share no storage with the HF model
    ptrs = {p.data_ptr() for p in hf_models[name].state_dict().values()}
    assert not ptrs & {t.data_ptr() for t in sd.values()}
    shared = set(pcfg.__dataclass_fields__) & set(
        jcfg.__dataclass_fields__)
    assert {"vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
            "dtype", "activation", "ln_eps"} <= shared
    for field in shared:
        assert getattr(pcfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("name", list(FAMILIES))
def test_logits_match_hf_and_jax(name, hf_models):
    _, jconv, pconv, kind = FAMILIES[name]
    hf = hf_models[name]
    pcfg, sd = pconv(hf)
    jcfg, jparams = jconv(hf)
    vocab = pcfg.vocab_size
    tokens = _tokens(name, vocab)
    types = np.random.RandomState(5).randint(0, 2, tokens.shape)
    model = _port_model(kind, pcfg, sd)
    jm = _jax_model(kind, jcfg)
    with torch.no_grad():
        if kind == "lm":
            got = [model(torch.from_numpy(tokens))]
            ref = [hf(torch.from_numpy(tokens)).logits]
            jax_out = [jm.apply({"params": jparams}, jnp.asarray(tokens))]
        elif kind == "encoder":
            got = [model(torch.from_numpy(tokens),
                         torch.from_numpy(types))]
            ref = [hf(torch.from_numpy(tokens),
                      token_type_ids=torch.from_numpy(types))
                   .last_hidden_state]
            jax_out = [jm.apply({"params": jparams}, jnp.asarray(tokens),
                                type_ids=jnp.asarray(types))[0]]
        else:
            got = list(model(torch.from_numpy(tokens),
                             torch.from_numpy(types)))
            out = hf(torch.from_numpy(tokens),
                     token_type_ids=torch.from_numpy(types))
            ref = [out.prediction_logits, out.seq_relationship_logits]
            jax_out = list(jm.apply({"params": jparams},
                                    jnp.asarray(tokens),
                                    type_ids=jnp.asarray(types)))
    for g, r, j in zip(got, ref, jax_out):
        g = g.float().numpy()
        np.testing.assert_allclose(g, r.numpy(), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(g, np.asarray(j), atol=TOL, rtol=TOL)


def _refusals():
    """(label, converter name, hf model or config) of every config the
    JAX converters refuse."""
    out = []
    bad_act = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=97, n_embd=32, n_layer=1, n_head=4)).eval()
    bad_act.config.activation_function = "tanh"
    out.append(("gpt2_activation", "from_hf_gpt2", bad_act))
    for flag, value in (("scale_attn_weights", False),
                        ("scale_attn_by_inverse_layer_idx", True),
                        ("reorder_and_upcast_attn", True)):
        out.append((f"gpt2_{flag}", "gpt2_config", transformers.GPT2Config(
            vocab_size=97, n_embd=32, n_layer=1, n_head=4,
            **{flag: value})))
    small = dict(vocab_size=53, hidden_size=16, intermediate_size=32,
                 num_hidden_layers=1, num_attention_heads=2)
    for label, kw in (("attention_bias", dict(attention_bias=True)),
                      ("mlp_bias", dict(mlp_bias=True)),
                      ("rope_scaling", dict(rope_scaling={
                          "rope_type": "linear", "factor": 2.0})),
                      ("attention_dropout", dict(attention_dropout=0.1)),
                      ("head_dim", dict(head_dim=4)),
                      ("hidden_act", dict(hidden_act="tanh"))):
        out.append((f"llama_{label}", "llama_config",
                    transformers.LlamaConfig(**small, **kw)))
    out.append(("mixtral_rope_scaling", "mixtral_config",
                transformers.MixtralConfig(
                    **small, num_local_experts=2, num_experts_per_tok=1,
                    rope_scaling={"rope_type": "linear", "factor": 2.0})))
    tiny = dict(vocab_size=60, hidden_size=16, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=32)
    out.append(("bert_decoder", "from_hf_bert", transformers.BertModel(
        transformers.BertConfig(**tiny, is_decoder=True,
                                add_cross_attention=True)).eval()))
    out.append(("bert_relative", "bert_config", transformers.BertConfig(
        **tiny, position_embedding_type="relative_key")))
    out.append(("bert_act", "bert_config", transformers.BertConfig(
        **tiny, hidden_act="tanh")))
    out.append(("bert_mlm_only", "from_hf_bert",
                transformers.BertForMaskedLM(transformers.BertConfig(
                    **tiny)).eval()))
    out.append(("bert_untied", "from_hf_bert",
                transformers.BertForPreTraining(transformers.BertConfig(
                    **tiny, tie_word_embeddings=False)).eval()))
    return out


def test_every_refused_config_raises_the_same_error():
    refusals = _refusals()
    assert len(refusals) == 16
    for label, fn, arg in refusals:
        errors = []
        for mod in (jax_convert, convert):
            with pytest.raises(ValueError) as info:
                getattr(mod, fn)(arg)
            errors.append(str(info.value))
        assert errors[0] == errors[1], label


@pytest.mark.parametrize("name", ["gpt2", "bert_model", "bert_pretraining",
                                  "llama_tied", "mixtral"])
def test_directory_form_gives_the_models_tensors(name, hf_models, tmp_path):
    _, _, pconv, _ = FAMILIES[name]
    hf_models[name].save_pretrained(tmp_path)
    cfg, sd = pconv(str(tmp_path))
    want_cfg, want = pconv(hf_models[name])
    assert cfg == want_cfg
    _assert_same_tensors(sd, want)


@pytest.mark.parametrize("name", ["gpt2", "bert_pretraining", "llama",
                                  "mixtral"])
def test_config_state_dict_pair_needs_no_transformers(name, hf_models,
                                                      monkeypatch,
                                                      tmp_path):
    _, _, pconv, _ = FAMILIES[name]
    hf = hf_models[name]
    want_cfg, want = pconv(hf)
    cfg_dict, sd = hf.config.to_dict(), hf.state_dict()
    monkeypatch.setitem(sys.modules, "transformers", None)
    for hf_cfg in (cfg_dict, hf.config):
        cfg, got = pconv((hf_cfg, sd))
        assert cfg == want_cfg
        _assert_same_tensors(got, want)
    with pytest.raises(ImportError, match="transformers"):
        pconv(str(tmp_path))


def test_mixtral_sliding_window_clamp_and_capacity():
    base = dict(vocab_size=53, hidden_size=16, intermediate_size=32,
                num_hidden_layers=1, num_attention_heads=2,
                num_local_experts=4, num_experts_per_tok=2,
                max_position_embeddings=128)
    for window, want in ((32, 32), (4096, 128), (None, 128)):
        hf_cfg = transformers.MixtralConfig(**base, sliding_window=window)
        ours = convert.mixtral_config(hf_cfg)
        assert ours.max_seq_len == want
        assert ours.max_seq_len == jax_convert.mixtral_config(
            hf_cfg).max_seq_len
        assert ours.moe_capacity_factor == 2.0 and ours.moe_every == 1
        assert ours.moe_router == "topk" and ours.moe_top_k == 2
    # an explicit capacity overrides the no-drop default
    assert convert.mixtral_config(
        transformers.MixtralConfig(**base),
        moe_capacity_factor=1.25).moe_capacity_factor == 1.25


def _burst(b, prompts, n):
    handles = [b.submit(p, n) for p in prompts]
    return [h.result(timeout=300) for h in handles]


@pytest.mark.parametrize("name", ["llama", "mixtral", "gpt2"])
def test_paged_batcher_decodes_the_jax_batchers_tokens(name, hf_models):
    _, jconv, pconv, _ = FAMILIES[name]
    hf = hf_models[name]
    jcfg, jparams = jconv(hf)
    pcfg, sd = pconv(hf)
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, pcfg.vocab_size, n).tolist()
               for n in (5, 19, 33)]
    jb = jax_serve.ContinuousBatcher(jax_tf.Transformer(jcfg), jparams,
                                     **ENGINE)
    try:
        want = _burst(jb, prompts, 12)
    finally:
        jb.stop()
    model = _port_model("lm", pcfg, sd).requires_grad_(False)
    b = serve.ContinuousBatcher(model, device="cpu", **ENGINE)
    try:
        got = _burst(b, prompts, 12)
        launches_paged = "kv_page_size" in b.stats()
    finally:
        b.stop()
    assert launches_paged
    assert got == want
    for p, o in zip(prompts, got):
        assert o[:len(p)] == p and len(o) == len(p) + 12
