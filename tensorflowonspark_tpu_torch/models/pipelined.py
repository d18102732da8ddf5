"""Pipeline-parallel flagship LM — counterpart of
``tensorflowonspark_tpu/models/pipelined.py``: the Transformer's blocks
over the ``pp`` axis (``parallel.pipeline``'s GPipe schedule).

The embedding and the head stay on every pp rank (data-parallel); the
block tower splits into ``n_stages`` contiguous stages, and on a pp mesh
each rank keeps only its stage's layers (``keep_stage``, called by
``parallel.sharding.shard_params``).  Parameters are named as the
sequential ``Transformer`` names them (``token_embed``, ``layer_<i>``,
``ln_f``, ``lm_head``), so ``from_transformer`` is a ``load_state_dict``
and ``convert.pipelined_from_jax`` maps the JAX layout (stacked
``[n_stages, layers/stage, ...]`` blocks) onto it.

The head is the Transformer's (``ln_f`` by ``norm_type``): the JAX
``_Head`` always builds a LayerNorm, so a JAX ``PipelinedLM`` of an
RMSNorm config cannot take its sequential checkpoint (ROADMAP §C).
"""
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_tpu_torch.models.transformer import (
    Block, Dense, _make_ln, check_ported, torch_dtype)
from tensorflowonspark_tpu_torch.parallel.mesh import AXIS_PP, active_mesh
from tensorflowonspark_tpu_torch.parallel.pipeline import pipeline_apply


class PipelinedLM(nn.Module):
    """Pipeline-parallel LM: dense MLPs only (``num_experts=0``, uniform
    stages), ``n_layers`` divisible by ``n_stages``, no decode mode.
    ``n_micro`` (default: the pp degree, the least that keeps every stage
    busy once the pipeline fills) splits the batch into micro-batches."""

    def __init__(self, cfg, n_stages, n_micro=None):
        super().__init__()
        if cfg.num_experts:
            raise ValueError(
                "PipelinedLM requires num_experts=0 (uniform blocks); "
                "shard experts over ep instead")
        if cfg.decode:
            raise NotImplementedError(
                "decode mode is not supported in the pipelined LM; decode "
                "with the sequential Transformer on a dp/tp mesh")
        if cfg.n_layers % n_stages:
            raise ValueError(f"n_layers={cfg.n_layers} must be divisible by "
                             f"n_stages={n_stages}")
        check_ported(cfg)
        self.cfg, self.n_stages, self.n_micro = cfg, n_stages, n_micro
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        if not cfg.rope:
            self.pos_embed = nn.Embedding(cfg.max_seq_len, cfg.d_model)
        self.layer_names = [f"layer_{i}" for i in range(cfg.n_layers)]
        for name in self.layer_names:
            self.add_module(name, Block(cfg))
        self.ln_f = _make_ln(cfg)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, False,
                             torch_dtype(cfg))
        self.stage = None

    @property
    def layers_per_stage(self):
        return self.cfg.n_layers // self.n_stages

    def from_transformer(self, model):
        """Take a sequential ``Transformer``'s parameters (the same
        names); returns self."""
        self.load_state_dict(model.state_dict())
        return self

    def keep_stage(self, stage):
        """Drop every layer outside stage ``stage``: a pp rank holds its
        stage's blocks, the embedding and the head."""
        lp = self.layers_per_stage
        keep = set(self.layer_names[stage * lp:(stage + 1) * lp])
        for name in self.layer_names:
            if name not in keep and hasattr(self, name):
                delattr(self, name)
        self.stage = stage

    def stage_layers(self, stage):
        lp = self.layers_per_stage
        return self.layer_names[stage * lp:(stage + 1) * lp]

    def grad_axes(self, mesh):
        """``(partial, distinct)`` for the train step: the embedding's
        gradient is stage 0's alone (summed over pp), and each stage's
        layers differ from the other pp ranks' (their squares summed
        over pp in the gradient norm)."""
        if mesh is None or mesh.shape.get(AXIS_PP, 1) == 1:
            return {}, {}
        partial, distinct = {}, {}
        for name, _ in self.named_parameters():
            if name.startswith(("token_embed.", "pos_embed.")):
                partial[name] = (AXIS_PP,)
            elif name.startswith("layer_"):
                distinct[name] = (AXIS_PP,)
        return partial, distinct

    def forward(self, tokens, n_micro=None):
        cfg = self.cfg
        mesh = active_mesh()
        pp = mesh.shape.get(AXIS_PP, 1) if mesh is not None else 1
        if pp != self.n_stages:
            # an exact multiple would silently drop stages in JAX
            raise ValueError(f"mesh pp axis size {pp} must equal "
                             f"n_stages={self.n_stages}")
        if pp > 1 and (mesh.shape["tp"] > 1 or mesh.shape["fsdp"] > 1):
            raise NotImplementedError(
                "a pipeline on a mesh that also splits parameters over tp "
                "or fsdp is not ported yet (ROADMAP A3c)")
        n_micro = n_micro or self.n_micro or self.n_stages
        B, S = tokens.shape
        if B % n_micro:
            raise ValueError(
                f"batch {B} must be divisible by n_micro={n_micro}")
        dt = torch_dtype(cfg)
        x = F.embedding(tokens, self.token_embed.weight).to(dt)
        if not cfg.rope:
            if S > cfg.max_seq_len:
                raise ValueError(f"sequence length {S} exceeds max_seq_len "
                                 f"{cfg.max_seq_len} (learned positions)")
            pos = torch.arange(S, device=tokens.device)[None]
            x = x + F.embedding(pos, self.pos_embed.weight).to(dt)
        stage = self.stage if self.stage is not None else 0
        if pp > 1 and self.stage != mesh.coords[AXIS_PP]:
            raise ValueError(
                f"this rank holds stage {self.stage}, its pp index is "
                f"{mesh.coords[AXIS_PP]} (place the model with "
                "parallel.sharding.shard_params / create_train_state)")
        blocks = [getattr(self, n) for n in self.stage_layers(stage)]
        params = {f"{i}.{k}": p for i, b in enumerate(blocks)
                  for k, p in b.named_parameters()}
        remat = cfg.remat and torch.is_grad_enabled()

        def stage_fn(_, h):
            for i, block in enumerate(blocks):
                h = (checkpoint(block, h, None, i, use_reentrant=False)
                     if remat else block(h))
            return h

        y = pipeline_apply(stage_fn, params,
                           x.reshape((n_micro, B // n_micro) + x.shape[1:]),
                           mesh)
        return self.lm_head(self.ln_f(y.reshape(x.shape)))
