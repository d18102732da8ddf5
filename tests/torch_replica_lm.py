"""A tiny decoder LM held by both packages, shared by the replica-side
tests of the port (migration, the host page tier, preemption, tracing):
initialised by the JAX package from a seed, carried to the port by
``convert.params_from_jax``, and helpers that serve it over HTTP on the
CPU.  Not a test module (no ``test_`` prefix)."""
import functools
import json
import threading
import urllib.error
import urllib.request

import numpy as np

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import transformer as jax_tf
from tensorflowonspark_tpu_torch import convert, export, quantize, serve
from tensorflowonspark_tpu_torch.models import decode as port_decode
from tensorflowonspark_tpu_torch.models import transformer as port_tf

CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq_len=128, rope=True, norm_type="rmsnorm")


@functools.lru_cache(maxsize=None)
def tiny_lm(dtype="float32"):
    """``(jax model, jax params (numpy), port model)`` at ``dtype``: the
    JAX model computes in it over f32 params; the port's float leaves
    are cast to it, as the server casts them."""
    cfg = dict(CFG, dtype=dtype)
    jm = jax_tf.Transformer(jax_tf.TransformerConfig(**cfg))
    params = jm.init(jax.random.key(9), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    pm = port_tf.build_transformer(**cfg)
    pm.load_state_dict(convert.params_from_jax(params), strict=True)
    pm = quantize.cast_float_leaves(pm, port_tf.torch_dtype(pm.cfg))
    return jm, params, pm.eval().requires_grad_(False)


def solo(pm, prompt, n, **kw):
    """The port's solo decode of one prompt (greedy unless ``kw``)."""
    return port_decode.generate(pm, [prompt], n, device="cpu",
                                **kw)[0].tolist()


def prompts(n, lo=5, hi=24, seed=3):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, CFG["vocab_size"], rs.randint(lo, hi)).tolist()
            for _ in range(n)]


def export_lm(tmp_dir, dtype="float32"):
    """The tiny LM exported in the port's format; returns its dir."""
    _, _, pm = tiny_lm(dtype)
    d = str(tmp_dir)
    export.export_saved_model(d, {k: v.float() for k, v in
                                  pm.state_dict().items()},
                              builder_kwargs=dict(CFG, dtype=dtype))
    return d


class Replica:
    """``make_server`` over an export with ``argv`` on 127.0.0.1 on the
    CPU, served from a thread; closed on exit."""

    def __init__(self, export_dir, *argv):
        args = serve.build_argparser().parse_args([
            "--export_dir", export_dir, "--port", "0", "--device", "cpu",
            *argv])
        self.args = args
        self.server, self.service = serve.make_server(args)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def batcher(self):
        return self.service.generate_service().batcher

    def url(self, path):
        return f"http://127.0.0.1:{self.port}{path}"

    def post(self, path, body, headers=None, timeout=120):
        """(status, headers, body bytes); an HTTP error is returned."""
        req = urllib.request.Request(
            self.url(path), data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def generate(self, body, headers=None):
        status, _, raw = self.post("/v1/models/default:generate", body,
                                   headers)
        assert status == 200, raw
        if body.get("stream"):
            return [json.loads(line) for line in raw.splitlines()]
        return json.loads(raw)["outputs"]

    def get(self, path, timeout=60):
        try:
            with urllib.request.urlopen(self.url(path),
                                        timeout=timeout) as resp:
                return resp.status, dict(resp.headers), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def conserved(b):
    """free + cached (refcount 0) + rows' own pages is the whole pool."""
    free = list(b._free_pages)
    cached = list(b._prefix.values())
    owned = [p for rp in b._row_pages if rp for p in rp
             if p not in b._page_rc]
    return (len(set(free)) == len(free) and b._sink not in free
            and sorted(free + cached + owned) == list(range(b._total_pages)))
