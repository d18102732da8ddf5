"""Kernels 4 and 11 launch directly when called eagerly, and through
their dispatcher ops (``tos::flash_fwd``, ``tos::layernorm``) only under
a trace.

- an eager ``fused_layernorm`` / ``flash_fwd`` / ``flash_attention`` call
  on a real CPU tensor records no ``tos::*`` op event in
  ``torch.profiler`` (calling the op itself does: the control), and
  gives the plain version's values;
- ``torch.export`` of a module calling both keeps the two ops as graph
  nodes, and so does a ``torch.compile`` capture (the wrapper sees
  ``torch.compiler.is_compiling()``);
- under ``FakeTensorMode`` the wrappers reach the ops' fake
  implementations (shapes only, no launch);
- ``_build.eager`` is False for a fake tensor and under a dispatch mode.

The launch counts on the card: ``tests/test_torch_cuda.py``
(``test_eager_kernel_4_and_11_launch_directly_and_count``).
"""
import pytest
import torch

from tensorflowonspark_tpu_torch.ops import _build
from tensorflowonspark_tpu_torch.ops import flash_attention as fa
from tensorflowonspark_tpu_torch.ops import layernorm as ln

OPS = ("tos::layernorm", "tos::flash_fwd")


def _inputs(seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((3, 5, 64), generator=gen)
    w = 1 + 0.1 * torch.randn(64, generator=gen)
    b = 0.1 * torch.randn(64, generator=gen)
    q = torch.randn((2, 16, 4, 64), generator=gen)
    k = torch.randn((2, 16, 2, 64), generator=gen)
    v = torch.randn((2, 16, 2, 64), generator=gen)
    return x, w, b, q, k, v


def _op_events(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted({e.name for e in prof.events() if e.name in OPS})


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_eager_calls_do_not_enter_the_dispatcher_ops(grad):
    x, w, b, q, k, v = _inputs()
    if grad:
        for t in (x, q):
            t.requires_grad_(True)
    out = {}

    def eager():
        out["ln"] = ln.fused_layernorm(x, w, b)
        out["fwd"] = fa.flash_fwd(q, k, v)
        out["attn"] = fa.flash_attention(q, k, v)

    with torch.set_grad_enabled(grad):
        assert _op_events(eager) == []
    torch.testing.assert_close(out["ln"], ln.layernorm_plain(x, w, b),
                               atol=0, rtol=0)
    want, lse = fa.flash_fwd_plain(q, k, v)
    torch.testing.assert_close(out["fwd"][0], want, atol=0, rtol=0)
    torch.testing.assert_close(out["fwd"][1], lse, atol=0, rtol=0)
    torch.testing.assert_close(out["attn"], want, atol=0, rtol=0)
    if grad:
        out["attn"].sum().backward()
        assert q.grad is not None and torch.isfinite(q.grad).all()


def test_the_ops_themselves_still_record_their_events():
    x, w, b, q, k, v = _inputs(1)
    got = _op_events(lambda: (
        torch.ops.tos.layernorm(x, w, b, 1e-6),
        torch.ops.tos.flash_fwd(q, k, v, True, 0.125, True)))
    assert got == sorted(OPS)


class _Both(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(w)
        self.b = torch.nn.Parameter(b)

    def forward(self, x, q, k, v):
        y = ln.fused_layernorm(x, self.w, self.b)
        return y, fa.flash_attention(q, k, v)


def test_export_and_compile_keep_both_ops_in_their_graphs():
    x, w, b, q, k, v = _inputs(2)
    module = _Both(w, b).eval()
    with torch.no_grad():
        program = torch.export.export(module, (x, q, k, v))
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
    assert {"tos.layernorm.default", "tos.flash_fwd.default"} <= targets
    got = program.module()(x, q, k, v)
    torch.testing.assert_close(got[0], ln.layernorm_plain(x, w, b))

    graphs = []

    def capture(gm, example_inputs):
        graphs.append(gm)
        return gm.forward

    torch._dynamo.reset()
    with torch.no_grad():
        torch.compile(module, backend=capture, fullgraph=True)(x, q, k, v)
    code = "".join(gm.code for gm in graphs)
    assert "tos.layernorm" in code and "tos.flash_fwd" in code


def test_fake_tensors_take_the_ops_fake_implementations():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty((2, 7, 64))
        w, b = torch.empty(64), torch.empty(64)
        q = torch.empty((1, 8, 4, 64))
        kv = torch.empty((1, 8, 2, 64))
        assert not _build.eager(x)
        y = ln.fused_layernorm(x, w, b)
        out, lse = fa.flash_fwd(q, kv, kv)
    assert y.shape == (2, 7, 64)
    assert out.shape == (1, 8, 4, 64) and lse.shape == (1, 4, 8)


def test_eager_is_false_under_a_dispatch_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    x, w, b, *_ = _inputs(3)
    assert _build.eager(x)
    with Seen() as mode:
        assert not _build.eager(x)
        y = ln.fused_layernorm(x, w, b)
    assert "tos.layernorm.default" in mode.ops
    torch.testing.assert_close(y, ln.layernorm_plain(x, w, b))
