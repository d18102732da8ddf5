"""Parity of the port's model zoo with the JAX package's, on the CPU.

The same numpy inputs go through each flax module (f32, CPU) and its
port (f32, ``device="cpu"``), the weights carried by ``convert``: the
JAX module's own init, then every leaf moved by seeded numpy noise, so
that the zero-init norm scales and SkipInit alphas are live.  Small
sizes: a block or two per stage, narrow widths, 32 x 32 images.

- ResNet: every ``norm`` x ``stem`` x ``output_stride`` combination, the
  CIFAR basic blocks with ``small_inputs``, ``features_only``, and
  BatchNorm's updated ``batch_stats`` in train mode;
- UNet, DeepLabV3, ViT (cls and mean pool), BertForPreTraining (with and
  without a key-padding mask, post- and pre-LN), MnistMLP, MnistCNN,
  Linear, MLP; ``apply_mlm_masking`` bit for bit from one seed;
- the layers the zoo builds on, against flax: SAME convs at strides 1
  and 2 (odd and even sizes), ``nn.ConvTranspose`` 4x4 / s2, SAME
  max-pool, and ``jax.image.resize`` bilinear at the borders;
- ``convert``: every zoo tree JAX -> port -> JAX bit for bit
  (``batch_stats`` included), a tree in the wrong layout raises, BERT's
  ``check_checkpoint_layout`` on both trees, ``port_builder`` maps every
  JAX model builder and ``get_model`` builds every registry name.

Tolerance of a forward: max |diff| <= 1e-4 * max(1, max |ref|) (f32 on
both sides; the products and reductions sum in other orders).
"""
import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import bert as jax_bert
from tensorflowonspark_tpu.models import cnn as jax_cnn
from tensorflowonspark_tpu.models import deeplab as jax_deeplab
from tensorflowonspark_tpu.models import linear as jax_linear
from tensorflowonspark_tpu.models import mlp as jax_mlp
from tensorflowonspark_tpu.models import resnet as jax_resnet
from tensorflowonspark_tpu.models import unet as jax_unet
from tensorflowonspark_tpu.models import vit as jax_vit
from tensorflowonspark_tpu_torch import convert, export, models
from tensorflowonspark_tpu_torch.models import bert as port_bert
from tensorflowonspark_tpu_torch.models import cnn as port_cnn
from tensorflowonspark_tpu_torch.models import common as port_common
from tensorflowonspark_tpu_torch.models import deeplab as port_deeplab
from tensorflowonspark_tpu_torch.models import linear as port_linear
from tensorflowonspark_tpu_torch.models import mlp as port_mlp
from tensorflowonspark_tpu_torch.models import resnet as port_resnet
from tensorflowonspark_tpu_torch.models import unet as port_unet
from tensorflowonspark_tpu_torch.models import vit as port_vit

F32 = "float32"


def _close(got, want, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _jax_vars(jm, x, seed):
    """Flax variables of ``jm`` in the structure and shapes its init
    gives (``jax.eval_shape``: traced, never compiled), filled with
    seeded numpy draws: ``0.5 * normal`` (so the zero-init norm scales
    and SkipInit alphas are live), ``var`` statistics ``1 + |0.3 *
    normal|``."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x))

    def fill(path, leaf):
        draw = rng.standard_normal(leaf.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return 1.0 + np.abs(0.3 * draw)
        return 0.5 * draw

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _load(pm, variables):
    pm.load_state_dict(convert.params_from_jax(variables), strict=True)
    return pm


def _images(seed, shape=(2, 32, 32, 3)):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# -------------------------------------------------------------- layers

@pytest.mark.parametrize("size,k,stride,dil", [
    (9, 3, 1, 1), (8, 3, 2, 1), (9, 3, 2, 1), (8, 1, 2, 1), (16, 7, 2, 1),
    (8, 4, 2, 1), (8, 3, 1, 2), (7, 4, 1, 1)])
def test_same_conv_matches_flax(size, k, stride, dil):
    x = _images(size, (2, size, size, 3))
    jm = fnn.Conv(5, (k, k), (stride, stride), padding="SAME",
                  kernel_dilation=(dil, dil))
    variables = _jax_vars(jm, x, 1)
    pm = _load(port_common.Conv(3, 5, (k, k), (stride, stride),
                                kernel_dilation=(dil, dil)),
               variables["params"])
    _close(pm(torch.from_numpy(x)), jm.apply(variables, x), (size, k))


@pytest.mark.parametrize("size,k,stride", [(4, 4, 2), (5, 4, 2),
                                           (5, 3, 2), (4, 2, 2), (4, 2, 3)])
def test_conv_transpose_matches_flax(size, k, stride):
    x = _images(size, (2, size, size, 6))
    jm = fnn.ConvTranspose(4, (k, k), (stride, stride), padding="SAME")
    variables = _jax_vars(jm, x, 2)
    pm = _load(port_common.ConvTranspose(6, 4, (k, k), (stride, stride)),
               variables["params"])
    want = jm.apply(variables, x)
    assert want.shape == (2, stride * size, stride * size, 4)
    _close(pm(torch.from_numpy(x)), want)


@pytest.mark.parametrize("size", [8, 9])
def test_same_max_pool_and_bilinear_resize_match_jax(size):
    x = _images(3, (2, size, size, 3))
    want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                        padding="SAME")
    _close(port_common.max_pool(torch.from_numpy(x), (3, 3), (2, 2),
                                padding="SAME"), want)
    # the DeepLab upsample: 16x and an uneven 3.5x, corners and edges
    for out in (size * 16, int(size * 3.5)):
        want = jax.image.resize(jnp.asarray(x), (2, out, out, 3),
                                "bilinear")
        got = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=(out, out),
            mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        _close(got, want, out)


# -------------------------------------------------------------- resnet

_RESNET = dict(stage_sizes=(1, 1, 1, 1), num_filters=4, num_classes=7,
               dtype=F32)


@pytest.mark.parametrize("norm", ["group", "batch", "none"])
@pytest.mark.parametrize("stem", ["conv", "s2d"])
@pytest.mark.parametrize("output_stride", [None, 16, 8])
def test_resnet_matches_jax(norm, stem, output_stride):
    kw = dict(_RESNET, norm=norm, stem=stem, output_stride=output_stride)
    x = _images(4)
    jm = jax_resnet.ResNet(**kw)
    variables = _jax_vars(jm, x, 5)
    pm = _load(port_resnet.ResNet(**kw), variables)
    _close(pm(torch.from_numpy(x)), jm.apply(variables, x))


def test_resnet_cifar_blocks_and_features_only_match_jax():
    x = _images(6)
    for kw in (dict(stage_sizes=(2, 1, 1), num_filters=4, bottleneck=False,
                    small_inputs=True, num_classes=5, dtype=F32),
               dict(_RESNET, features_only=True, output_stride=16)):
        jm = jax_resnet.ResNet(**kw)
        variables = _jax_vars(jm, x, 7)
        pm = _load(port_resnet.ResNet(**kw), variables)
        _close(pm(torch.from_numpy(x)), jm.apply(variables, x))
    assert port_resnet.ResNet56Cifar().block_names[-1] == "stage2_block8"


def test_batchnorm_train_updates_batch_stats_like_flax():
    kw = dict(_RESNET, norm="batch")
    x = _images(8)
    jm = jax_resnet.ResNet(**kw)
    variables = _jax_vars(jm, x, 9)
    pm = _load(port_resnet.ResNet(**kw), variables)
    want, updated = jm.apply(variables, x, train=True,
                           mutable=["batch_stats"])
    _close(pm(torch.from_numpy(x), train=True), want)
    got = convert.variables_to_jax(pm.state_dict())["batch_stats"]
    flat = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, updated["batch_stats"])))
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        _close(leaf, flat[path], jax.tree_util.keystr(path))
    # eval mode reads the updated statistics
    _close(pm(torch.from_numpy(x)),
           jm.apply(dict(variables, batch_stats=updated["batch_stats"]), x))


# ------------------------------------------------- unet, deeplab, small

def test_unet_matches_jax():
    kw = dict(num_classes=3, features=(4, 8, 16), dtype=F32)
    x = _images(10)
    jm = jax_unet.UNet(**kw)
    variables = _jax_vars(jm, x, 11)
    pm = _load(port_unet.UNet(**kw), variables)
    want = jm.apply(variables, x)
    got = pm(torch.from_numpy(x))
    _close(got, want)
    labels = np.random.RandomState(12).randint(0, 3, (2, 32, 32))
    assert port_unet.pixel_cross_entropy(
        got, torch.from_numpy(labels)).item() == pytest.approx(
        float(jax_unet.pixel_cross_entropy(want, labels)), rel=1e-5)


@pytest.mark.parametrize("norm", ["group", "none"])
def test_deeplab_matches_jax(norm):
    kw = dict(num_classes=5, stage_sizes=(1, 1, 1, 1), num_filters=4,
              aspp_features=8, norm=norm, dtype=F32)
    x = _images(13)
    jm = jax_deeplab.DeepLabV3(**kw)
    variables = _jax_vars(jm, x, 14)
    pm = _load(port_deeplab.DeepLabV3(**kw), variables)
    _close(pm(torch.from_numpy(x)), jm.apply(variables, x))


def test_mnist_and_linear_models_match_jax():
    rng = np.random.RandomState(15)
    imgs = rng.standard_normal((3, 28, 28, 1)).astype(np.float32)
    flat = imgs.reshape(3, 784)
    feats = rng.standard_normal((3, 5)).astype(np.float32)
    cases = [(jax_mlp.MnistMLP(hidden=16), port_mlp.MnistMLP(hidden=16),
              flat),
             (jax_cnn.MnistCNN(), port_cnn.MnistCNN(), imgs),
             (jax_cnn.MnistCNN(), port_cnn.MnistCNN(), flat),
             (jax_linear.Linear(), port_linear.Linear(in_features=5), feats),
             (jax_linear.Linear(features=3),
              port_linear.Linear(features=3, in_features=5), feats),
             (jax_linear.MLP(features=(8, 4)),
              port_linear.MLP(features=(8, 4), in_features=5), feats)]
    outs = []
    for i, (jm, pm, x) in enumerate(cases):
        variables = _jax_vars(jm, x, 16 + i)
        _load(pm, variables)
        want = jm.apply(variables, x)
        got = pm(torch.from_numpy(x))
        _close(got, want, type(pm).__name__)
        outs.append((got, want))
    labels = rng.randint(0, 10, (3,))
    got, want = outs[0]                     # MnistMLP's logits
    assert port_mlp.cross_entropy_loss(got, torch.from_numpy(labels)) \
        .item() == pytest.approx(float(jax_mlp.cross_entropy_loss(
            jnp.asarray(want), labels)), rel=1e-5)
    # dropout in train mode: the kept elements scaled by 2, the rest 0
    cnn = cases[1][1]
    g = torch.Generator().manual_seed(0)
    out = cnn(torch.from_numpy(imgs), train=True, generator=g)
    assert out.shape == (3, 10) and torch.isfinite(out).all()


# ------------------------------------------------------------ vit, bert

_VIT = dict(image_size=32, patch_size=8, num_classes=6, d_model=32,
            n_heads=2, n_layers=2, d_ff=64, dtype=F32)


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit_matches_jax(pool):
    cfg = dict(_VIT, pool=pool)
    x = _images(20)
    jm = jax_vit.ViT(jax_vit.ViTConfig(**cfg))
    variables = _jax_vars(jm, x, 21)
    pm = _load(port_vit.ViT(port_vit.ViTConfig(**cfg)), variables)
    _close(pm(torch.from_numpy(x)), jm.apply(variables, x))


_BERT = dict(vocab_size=40, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_seq_len=16, dtype=F32)
_PRE_LN = dict(norm_style="pre", use_bias=False, activation="gelu_tanh",
               ln_eps=1e-6)


@pytest.mark.parametrize("style", ["post", "pre"])
@pytest.mark.parametrize("masked", [False, True])
def test_bert_pretraining_matches_jax(style, masked):
    cfg = dict(_BERT, **(_PRE_LN if style == "pre" else {}))
    rng = np.random.RandomState(22)
    tokens = rng.randint(0, 40, (2, 12))
    type_ids = rng.randint(0, 2, (2, 12))
    mask = np.ones((2, 12), bool)
    mask[1, 8:] = False
    jm = jax_bert.BertForPreTraining(jax_bert.BertConfig(**cfg))
    variables = _jax_vars(jm, tokens, 23)
    pm = _load(port_bert.BertForPreTraining(port_bert.BertConfig(**cfg)),
               variables)
    kw = dict(attention_mask=mask) if masked else {}
    want = jm.apply(variables, tokens, type_ids, **kw)
    got = pm(torch.from_numpy(tokens), torch.from_numpy(type_ids),
             **({"attention_mask": torch.from_numpy(mask)} if masked
                else {}))
    _close(got[0], want[0], "mlm")
    _close(got[1], want[1], "nsp")
    targets = np.where(rng.random_sample((2, 12)) < 0.3, tokens, -1)
    labels = np.array([0, 1])
    assert port_bert.mlm_loss(got[0], torch.from_numpy(targets)).item() == \
        pytest.approx(float(jax_bert.mlm_loss(want[0], targets)), rel=1e-5)
    assert port_bert.nsp_loss(got[1], torch.from_numpy(labels)).item() == \
        pytest.approx(float(jax_bert.nsp_loss(want[1], labels)), rel=1e-5)


def test_mlm_masking_bit_for_bit():
    tokens = np.random.RandomState(24).randint(0, 30522, (4, 128))
    for seed in (0, 7, 123):
        want = jax_bert.apply_mlm_masking(seed, tokens, 103, 30522)
        got = port_bert.apply_mlm_masking(seed, tokens, 103, 30522)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert (got[1] >= 0).any()


# ------------------------------------------------------------- convert

def _zoo_trees():
    """``(name, flax variables, port module)`` of every zoo model at a
    small size."""
    x = _images(30)
    tokens = np.zeros((1, 8), np.int32)
    specs = [
        ("resnet-group", jax_resnet.ResNet(**_RESNET),
         port_resnet.ResNet(**_RESNET), x),
        ("resnet-batch", jax_resnet.ResNet(**_RESNET, norm="batch"),
         port_resnet.ResNet(**_RESNET, norm="batch"), x),
        ("resnet-none-s2d", jax_resnet.ResNet(**_RESNET, norm="none",
                                              stem="s2d"),
         port_resnet.ResNet(**_RESNET, norm="none", stem="s2d"), x),
        ("unet", jax_unet.UNet(features=(4, 8), dtype=F32),
         port_unet.UNet(features=(4, 8), dtype=F32), x),
        ("deeplab", jax_deeplab.DeepLabV3(stage_sizes=(1, 1, 1, 1),
                                          num_filters=4, aspp_features=8,
                                          norm="batch", dtype=F32),
         port_deeplab.DeepLabV3(stage_sizes=(1, 1, 1, 1), num_filters=4,
                                aspp_features=8, norm="batch", dtype=F32),
         x),
        ("vit", jax_vit.ViT(jax_vit.ViTConfig(**_VIT)),
         port_vit.ViT(port_vit.ViTConfig(**_VIT)), x),
        ("bert", jax_bert.BertForPreTraining(jax_bert.BertConfig(**_BERT)),
         port_bert.BertForPreTraining(port_bert.BertConfig(**_BERT)),
         tokens),
        ("mnist_cnn", jax_cnn.MnistCNN(), port_cnn.MnistCNN(),
         np.zeros((1, 28, 28, 1), np.float32)),
        ("mnist_mlp", jax_mlp.MnistMLP(hidden=8), port_mlp.MnistMLP(
            hidden=8), np.zeros((1, 784), np.float32)),
    ]
    return [(name, _jax_vars(jm, inp, 31), pm)
            for name, jm, pm, inp in specs]


def test_every_zoo_tree_round_trips_bit_for_bit():
    for name, variables, pm in _zoo_trees():
        state = convert.params_from_jax(variables)
        pm.load_state_dict(state, strict=True)
        back = convert.variables_to_jax(pm.state_dict())
        assert set(back) == set(variables), name
        want = jax.tree_util.tree_leaves_with_path(variables)
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(want) == len(got), name
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], leaf,
                                          err_msg=f"{name} {path}")


def test_a_tree_in_the_wrong_layout_raises():
    name, variables, pm = _zoo_trees()[0]
    state = convert.params_from_jax(variables)
    # a conv kernel left in flax's HWIO layout
    state["conv_init.weight"] = torch.from_numpy(np.asarray(
        variables["params"]["conv_init"]["kernel"]))
    with pytest.raises(RuntimeError, match="size mismatch"):
        pm.load_state_dict(state, strict=True)
    with pytest.raises(ValueError, match="unknown parameter"):
        convert.params_from_jax({"conv_init": {"kernal": np.zeros(3)}})
    with pytest.raises(ValueError, match="2-D Dense or 4-D conv"):
        convert.params_from_jax({"dense": {"kernel": np.zeros(3)}})
    # BERT's check, on a flax tree and on the port's state_dict
    post = port_bert.BertConfig(**_BERT)
    pre = port_bert.BertConfig(**_BERT, **_PRE_LN)
    jpre = _jax_vars(jax_bert.BertForPreTraining(jax_bert.BertConfig(
        **_BERT, **_PRE_LN)), np.zeros((1, 4), np.int32), 32)
    for tree in (jpre, port_bert.BertForPreTraining(pre).state_dict()):
        port_bert.check_checkpoint_layout(pre, tree)
        with pytest.raises(ValueError, match="pre-LN layout"):
            port_bert.check_checkpoint_layout(post, tree)
        with pytest.raises(ValueError, match="pre-LN layout"):
            jax_bert.check_checkpoint_layout(
                jax_bert.BertConfig(**_BERT), jpre)
    sd = port_bert.BertForPreTraining(post).state_dict()
    with pytest.raises(ValueError, match="lacks encoder/ln_f"):
        port_bert.check_checkpoint_layout(pre, sd)


def test_port_builder_maps_every_jax_model_builder():
    import importlib

    for jax_spec, port_spec in convert.JAX_BUILDERS.items():
        assert convert.port_builder(jax_spec) == port_spec
        mod, _, attr = jax_spec.partition(":")
        assert callable(getattr(importlib.import_module(mod), attr))
        assert callable(export._resolve_builder(jax_spec))
    # every builder function and zoo class of the JAX models package
    for mod, attr in (("bert", "build_bert"), ("cnn", "MnistCNN"),
                      ("resnet", "ResNet50"), ("deeplab", "DeepLabV3"),
                      ("transformer", "build_transformer")):
        assert f"tensorflowonspark_tpu.models.{mod}:{attr}" in \
            convert.JAX_BUILDERS
    with pytest.raises(NotImplementedError, match="no counterpart"):
        convert.port_builder("tensorflowonspark_tpu.models.pipelined:"
                             "PipelinedLM")


@pytest.mark.parametrize("name", sorted(models._REGISTRY))
def test_get_model_builds_every_registry_name(name, monkeypatch):
    small = {"resnet": dict(_RESNET), "unet": dict(features=(4, 8)),
             "deeplabv3": dict(stage_sizes=(1, 1, 1, 1), num_filters=4,
                               aspp_features=8),
             "transformer": dict(cfg=__import__(
                 "tensorflowonspark_tpu_torch.models.transformer",
                 fromlist=["TransformerConfig"]).TransformerConfig(
                 vocab_size=16, d_model=16, n_heads=2, n_layers=1, d_ff=16,
                 max_seq_len=8)),
             "bert": dict(cfg=port_bert.BertConfig(**_BERT))}.get(name, {})
    m = models.get_model(name, device="cpu", **small)
    assert all(p.device.type == "cpu" for p in m.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.get_model(name, **small)
