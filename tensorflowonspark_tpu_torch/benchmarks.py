"""The flagship configurations the port is sized against (copies of the
JAX package's ``benchmarks`` dicts; the port imports nothing from that
package), and :func:`make_flagship_step`, the flagship training step."""

# 0.87B decoder LM: RoPE, GQA 16 q / 8 kv heads (head_dim 128), bf16
FLAGSHIP_LM = dict(
    vocab_size=32000, d_model=2048, n_heads=16, n_kv_heads=8,
    n_layers=16, d_ff=8192, max_seq_len=1024, dtype="bfloat16",
    rope=True, attention_impl="auto")
# the same dims with RMSNorm: the configuration the port serves
FLAGSHIP_LM_V2 = dict(FLAGSHIP_LM, norm_type="rmsnorm")
# steady-state paged decode: 16 slots, page 64, rows filled to 2000 of 4096
FLAGSHIP_DECODE = dict(n_slots=16, page_size=64, max_seq=4096, fill=2000)
# steady-state batched paged prefill: 4 rows, chunk 256 at offset 2000
FLAGSHIP_PREFILL_KERNEL = dict(n_slots=4, page_size=64, max_seq=4096,
                               fill=2000, chunk=256)
# the flagship training step: batch 8 x max_seq_len tokens, the
# single-pass fused AdamW with a bf16 first moment
FLAGSHIP_BATCH = 8
FLAGSHIP_MU_DTYPE = "bfloat16"
FLAGSHIP_OPTIMIZER = "adamw_fused"


def make_flagship_step(batch_size=None, seq_len=None, config="v2",
                       optimizer=None, device=None):
    """Build the flagship-LM training step as the JAX package's
    ``make_flagship_step`` builds it: returns ``(step, state, tokens,
    n_params)``; call as ``state, m = step(state, tokens, rng)``.

    ``config``: "v2" (rmsnorm), "v1" (layernorm), or a dict of
    TransformerConfig fields (a small model for the CPU).  ``optimizer``: None
    -> FLAGSHIP_OPTIMIZER (adamw_fused, kernel 7); "adamw" -> the plain
    optax-semantics AdamW; "sgd0" -> zero-lr momentum-less SGD.  The
    parameters are f32 masters with bf16 compute through ``Dense``'s
    cast, random from a seed (0); tokens ``[B, S + 1]`` come from
    ``np.random.RandomState(0)``.  ``device`` defaults to ``cuda``
    (``device.resolve``)."""
    import numpy as np
    import torch

    from tensorflowonspark_tpu_torch.device import resolve
    from tensorflowonspark_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, lm_loss)
    from tensorflowonspark_tpu_torch.optim import make_optimizer
    from tensorflowonspark_tpu_torch.parallel import train as train_mod

    dev = resolve(device)
    if isinstance(config, dict):
        cfg_kw = dict(config)
    else:
        cfg_kw = dict(FLAGSHIP_LM_V2 if config == "v2" else FLAGSHIP_LM)
    if seq_len:
        cfg_kw["max_seq_len"] = seq_len
    B = batch_size or FLAGSHIP_BATCH
    S = cfg_kw["max_seq_len"]
    cfg = TransformerConfig(**cfg_kw)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S + 1))).to(dev)
    with torch.device(dev):
        model = Transformer(cfg)      # f32 master params
    model.reset_parameters(torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())

    def loss_fn(m, batch, rng):
        return lm_loss(m(batch[:, :-1]), batch[:, 1:])

    name = optimizer or FLAGSHIP_OPTIMIZER
    if name == "sgd0":
        # momentum=None (not 0.0): a trace state would put optimizer
        # bandwidth back into the "no optimizer" baseline
        opt, _ = make_optimizer("sgd", learning_rate=0.0, momentum=None)
    else:
        opt, _ = make_optimizer(name, learning_rate=3e-4,
                                mu_dtype=FLAGSHIP_MU_DTYPE)
    state = train_mod.create_train_state(model, opt)
    step = train_mod.make_train_step(loss_fn, opt, donate=True)
    return step, state, tokens, n_params
