"""The port's ``:predict`` endpoint against the JAX server's
(``tests/test_serve.py``), real HTTP round trips on the CPU.

- Both servers serve the same JAX-package exports — ``Linear``, the
  zoo's ``MnistCNN`` and a 2-block ViT at width 64 (f32 weights drawn
  with numpy from a seed) — and their predictions agree within 1e-5 x
  max(1, |ref|) (f32 on both sides; the port's convolutions and matmuls
  sum in another order than XLA's);
- bare rows map onto a single-input model; ``--input_mapping``,
  ``--output_mapping`` and ``--signature_def_key`` rename and select as
  in the JAX server;
- micro-batching (``--batch_wait_ms``) coalesces 8 concurrent requests
  into fewer executions, each caller getting its own rows; a malformed
  request fails alone; a predictor failure fails its window and the
  batcher serves the next one;
- malformed bodies answer 400, unknown paths 404, a draining server 503
  with Retry-After, and ``:generate`` on an export that is no decoder LM
  404; metadata counts ``requests_served``, names the ``engine`` and
  counts ``batched_executions``.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import export as jax_export
from tensorflowonspark_tpu import serve as jax_serve
from tensorflowonspark_tpu_torch import serve

TOL = 1e-5
JAX_MODELS = "tensorflowonspark_tpu.models."
# (builder, kwargs, input name, per-row input shape)
MODELS = {
    "linear": ("linear:Linear", {"features": 1}, "x", (2,)),
    "cnn": ("cnn:MnistCNN", {}, "image", (28, 28, 1)),
    "vit": ("vit:ViTBase", dict(image_size=16, patch_size=4, num_classes=7,
                                d_model=64, n_heads=4, n_layers=2, d_ff=128,
                                dtype="float32"), "image", (16, 16, 3)),
}


def _jax_params(builder, kwargs, shape, seed):
    """Flax params of the builder's module in the shapes its init gives
    (``jax.eval_shape``: never compiled), filled with seeded numpy
    draws (0.5 x normal, so no weight is trivially zero)."""
    import importlib

    mod, _, fn = (JAX_MODELS + builder).partition(":")
    jm = getattr(importlib.import_module(mod), fn)(**kwargs)
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1,) + shape, jnp.float32))["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: 0.5 * rng.standard_normal(a.shape).astype(np.float32),
        shapes)


def _signatures(name, shape, extra=False):
    sig = {"inputs": {name: {"shape": list(shape), "dtype": "float32"}},
           "outputs": ["y"]}
    sigs = {"serving_default": sig}
    if extra:
        sigs["scores"] = {"inputs": {name: dict(sig["inputs"][name])},
                          "outputs": ["score"]}
    return sigs


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict")
    out = {}
    for i, (key, (builder, kwargs, name, shape)) in enumerate(MODELS.items()):
        d = str(root / key)
        jax_export.export_saved_model(
            d, _jax_params(builder, kwargs, shape, 30 + i),
            builder=JAX_MODELS + builder, builder_kwargs=kwargs,
            signatures=_signatures(name, shape, extra=key == "linear"))
        out[key] = d
    return out


class _Running:
    """A server of ``mod`` (the JAX package's serve or the port's) on an
    ephemeral port, in a thread; closed on exit."""

    def __init__(self, mod, export_dir, *flags):
        argv = ["--export_dir", export_dir, "--port", "0", *flags]
        if mod is serve:
            argv += ["--device", "cpu"]
        self.srv, self.service = mod.make_server(
            mod.build_argparser().parse_args(argv))
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.base = "http://%s:%d" % self.srv.server_address[:2]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()

    def post(self, path, payload):
        req = urllib.request.Request(
            self.base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, dict(r.headers), json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), json.loads(e.read())

    def predict(self, instances, name="default"):
        return self.post(f"/v1/models/{name}:predict",
                         {"instances": instances})

    def meta(self):
        with urllib.request.urlopen(self.base + "/v1/models/default",
                                    timeout=60) as r:
            return json.loads(r.read())


def _rows(key, n, seed):
    _, _, name, shape = MODELS[key]
    x = np.random.RandomState(seed).standard_normal((n,) + shape)
    return name, x.astype(np.float32).tolist()


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("key", list(MODELS))
def test_port_and_jax_servers_agree(exports, key):
    name, rows = _rows(key, 3, 40)
    instances = [{name: r} for r in rows]
    with _Running(jax_serve, exports[key]) as j, \
            _Running(serve, exports[key]) as p:
        sj, _, want = j.predict(instances)
        sp, _, got = p.predict(instances)
        assert sj == sp == 200
        assert len(got["predictions"]) == 3
        for g, w in zip(got["predictions"], want["predictions"]):
            assert set(g) == set(w) == {"y"}
            _close(g["y"], w["y"])
        meta = p.meta()["model"]
        assert meta["requests_served"] == 1
        assert meta["engine"].startswith("builder(batch=64")


def test_bare_rows_and_the_mapping_flags(exports):
    _, rows = _rows("linear", 5, 41)
    with _Running(jax_serve, exports["linear"]) as j, \
            _Running(serve, exports["linear"]) as p:
        # bare rows map onto the single input; 5 rows pad the tail chunk
        sj, _, want = j.predict(rows)
        sp, _, got = p.predict(rows)
        assert sj == sp == 200
        _close([r["y"] for r in got["predictions"]],
               [r["y"] for r in want["predictions"]])
    flags = ["--signature_def_key", "scores", "--input_mapping",
             '{"feat": "x"}', "--output_mapping", '{"score": "s"}',
             "--batch_size", "2"]
    with _Running(jax_serve, exports["linear"], *flags) as j, \
            _Running(serve, exports["linear"], *flags) as p:
        instances = [{"feat": r} for r in rows]
        sj, _, want = j.predict(instances)
        sp, _, got = p.predict(instances)
        assert sj == sp == 200
        assert all(set(r) == {"s"} for r in got["predictions"])
        _close([r["s"] for r in got["predictions"]],
               [r["s"] for r in want["predictions"]])
        # bare rows key the fed feature name (after the mapping)
        assert p.predict(rows)[0] == 200
        assert p.service._predict_rows.input_names == ["feat"]
        assert p.meta()["model"]["engine"].startswith("builder(batch=2")


@pytest.fixture(scope="module")
def batched(exports):
    with _Running(serve, exports["linear"], "--batch_wait_ms", "50") as p:
        yield p


def test_micro_batching_coalesces_concurrent_requests(batched):
    _, rows = _rows("linear", 8, 42)
    want = batched.service._predict_rows({"x": rows}, 8)["y"]
    results, errors = {}, []

    def call(i):
        try:
            status, _, out = batched.predict([{"x": rows[i]}])
            results[i] = (status, out["predictions"][0]["y"])
        except Exception as e:   # pragma: no cover - reported below
            errors.append(e)

    before = batched.service._batcher.executions
    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(results) == 8
    for i, (status, y) in results.items():
        assert status == 200
        _close(y, want[i])
    executed = batched.service._batcher.executions - before
    assert executed < 8, f"no coalescing happened ({executed} executions)"
    assert batched.meta()["model"]["batched_executions"] >= executed


def test_micro_batching_isolates_a_malformed_request(batched):
    results, errors = {}, {}

    def good(i):
        results[i] = batched.predict([{"x": [1.0, 2.0]}])[0]

    def bad():
        errors["bad"] = batched.predict([{"z": [1.0, 2.0]}])[0]

    threads = ([threading.Thread(target=good, args=(i,)) for i in range(4)]
               + [threading.Thread(target=bad)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert sorted(results.values()) == [200] * 4
    assert errors["bad"] == 400


def test_micro_batcher_survives_a_predictor_failure(batched):
    real = batched.service._batcher._predict

    def boom(cols, n):
        raise RuntimeError("injected predictor failure")

    batched.service._batcher._predict = boom
    try:
        status, _, body = batched.predict([{"x": [1.0, 2.0]}])
        assert status == 500 and "injected" in body["error"]
    finally:
        batched.service._batcher._predict = real
    status, _, out = batched.predict([{"x": [1.0, 2.0]}])
    assert status == 200 and len(out["predictions"]) == 1


def test_errors_unknown_paths_and_the_drain(exports):
    with _Running(serve, exports["linear"]) as p:
        for payload in ({"instances": []},
                        {"instances": [{"x": [1.0, 2.0]}, {"z": [1.0]}]},
                        {}, {"instances": [{"x": [1.0, 2.0]}, 2.0]}):
            assert p.post("/v1/models/default:predict", payload)[0] == 400
        assert p.post("/v1/models/default:predict", [1, 2])[0] == 400
        for path in ("/v1/models/other:explain", "/v1/models/resnet:predict",
                     "/v1/models/default:explain"):
            assert p.post(path, {"instances": [{"x": [0.0, 0.0]}]})[0] == 404
        status, _, body = p.post("/v1/models/default:generate",
                                 {"inputs": [[1, 2]]})
        assert status == 404 and "not a Transformer" in body["error"]
        assert p.predict([{"x": [0.0, 0.0]}])[0] == 200   # still serving
        assert p.post("/v1/fleet:drain", {})[2]["drained"] is True
        status, headers, body = p.predict([{"x": [1.0, 2.0]}])
        assert status == 503 and body["type"] == "draining"
        assert headers["Retry-After"] == "1"
        assert p.meta()["status"] == "draining"


def test_weights_load_at_the_first_predict(exports):
    with _Running(serve, exports["cnn"]) as p:
        predictor = p.service._predict_rows
        assert predictor._predict is None   # signature read, weights not
        assert predictor.input_names == ["image"]
        name, rows = _rows("cnn", 1, 43)
        assert p.predict([{name: rows[0]}])[0] == 200
        assert predictor._predict is not None
