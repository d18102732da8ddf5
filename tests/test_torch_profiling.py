"""The port's profiling (``utils/profiling``) and ``POST
/v1/debug:profile``, on the CPU.

- ``parse_trace`` over a handmade torch Chrome trace: device events only
  (``kernel``, ``gpu_memcpy``, ``gpu_memset``) grouped by name without
  signature, the same ungrouped, and host events included — the JAX
  ``parse_perfetto_trace``'s contract over torch's format; a ``.json.gz``
  path reads too;
- ``op_breakdown`` of a CPU function: its trace holds no device rows,
  so it gives the host ops, the matmul among them;
- ``/v1/debug:profile`` on a CPU server: 200 with a trace file that
  parses (the capture saw the :predict served during it), 400 for a bad
  ``duration_ms`` or ``dir``, 409 while another capture runs, and a 200
  relayed by the port's gateway;
- ``start_profiler_server`` raises, naming the route.
"""
import gzip
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from tensorflowonspark_tpu_torch import export, fleet, serve
from tensorflowonspark_tpu_torch.models.linear import Linear
from tensorflowonspark_tpu_torch.utils import profiling

EVENTS = [
    {"ph": "M", "name": "process_name", "pid": 0,
     "args": {"name": "python"}},
    {"ph": "X", "cat": "kernel", "name":
     "void tos::flash_fwd_kernel<float, 64, true>(tos::FlashArgs)",
     "pid": 0, "tid": 7, "ts": 10, "dur": 30},
    {"ph": "X", "cat": "kernel", "name":
     "void tos::flash_fwd_kernel<float, 128, false>(tos::FlashArgs)",
     "pid": 0, "tid": 7, "ts": 50, "dur": 12},
    {"ph": "X", "cat": "kernel", "name":
     "void at::native::elementwise_kernel<128, 2>(int, float)",
     "pid": 0, "tid": 7, "ts": 70, "dur": 5},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> "
     "Device)", "pid": 0, "tid": 8, "ts": 0, "dur": 4},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0,
     "tid": 8, "ts": 80, "dur": 1},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1,
     "ts": 0, "dur": 40},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "pid": 1, "tid": 1, "ts": 2, "dur": 3},
    {"ph": "i", "cat": "kernel", "name": "marker", "pid": 0, "ts": 5},
    {"ph": "X", "cat": "kernel", "name": "no duration", "pid": 0, "ts": 5},
]


def test_parse_trace_groups_and_filters(tmp_path):
    assert profiling.parse_trace(EVENTS) == [
        ("tos::flash_fwd_kernel", 42, 2),
        ("at::native::elementwise_kernel", 5, 1), ("Memcpy HtoD", 4, 1),
        ("Memset", 1, 1)]
    ungrouped = profiling.parse_trace({"traceEvents": EVENTS}, group=False)
    assert [r[1:] for r in ungrouped] == [(30, 1), (12, 1), (5, 1), (4, 1),
                                         (1, 1)]
    assert ungrouped[1][0].startswith("void tos::flash_fwd_kernel<float, 128")
    path = tmp_path / "trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": EVENTS}, f)
    everything = profiling.parse_trace(str(path), device_only=False)
    assert everything[:2] == [("tos::flash_fwd_kernel", 42, 2),
                              ("aten::mm", 40, 1)]
    assert ("cudaLaunchKernel", 3, 1) in everything and len(everything) == 6


def test_op_breakdown_of_a_cpu_function(tmp_path):
    x = torch.randn(64, 64)

    def fn(a):
        return torch.relu(a @ a)

    rows = profiling.op_breakdown(fn, x, steps=2, log_dir=str(tmp_path))
    names = {name: n for name, _, n in rows}
    assert names["aten::relu"] == 2 and "aten::mm" in names
    trace = str(tmp_path / profiling.TRACE_FILE)
    assert profiling.parse_trace(trace) == []       # nothing on a device
    assert rows == profiling.parse_trace(trace, device_only=False)


def test_start_profiler_server_raises():
    with pytest.raises(NotImplementedError, match="debug:profile"):
        profiling.start_profiler_server(9012)


def _post(base, path, payload, timeout=60):
    req = urllib.request.Request(base + path, data=json.dumps(payload)
                                 .encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def linear_export(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("profile") / "lin")
    model = Linear(features=3, in_features=4)
    export.export_saved_model(
        d, model.state_dict(),
        builder="tensorflowonspark_tpu_torch.models.linear:Linear",
        builder_kwargs={"features": 3, "in_features": 4},
        signatures={"serving_default": {
            "inputs": {"x": {"shape": [4], "dtype": "float32"}},
            "outputs": ["y"]}})
    return d


def _server(export_dir, *flags):
    args = serve.build_argparser().parse_args([
        "--export_dir", export_dir, "--port", "0", "--device", "cpu",
        *flags])
    srv, service = serve.make_server(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return args, srv, service, "http://%s:%d" % srv.server_address[:2]


def test_debug_profile_captures_and_refuses(linear_export, tmp_path):
    _, srv, _, base = _server(linear_export)
    try:
        box = {}

        def capture():
            box["first"] = _post(base, "/v1/debug:profile",
                                 {"duration_ms": 1500,
                                  "dir": str(tmp_path / "cap")})

        t = threading.Thread(target=capture)
        t.start()
        time.sleep(0.4)
        # a second capture while the first holds the profiler
        assert _post(base, "/v1/debug:profile", {"duration_ms": 10})[0] == 409
        assert _post(base, "/v1/models/default:predict",
                     {"instances": [{"x": [1.0, 2.0, 3.0, 4.0]}]})[0] == 200
        t.join(timeout=60)
        status, body = box["first"]
        assert status == 200 and body["duration_ms"] == 1500.0
        assert body["artifact"] == str(tmp_path / "cap" /
                                       profiling.TRACE_FILE)
        with open(body["artifact"]) as f:
            assert "traceEvents" in json.load(f)
        host = dict((n, c) for n, _, c in profiling.parse_trace(
            body["artifact"], device_only=False))
        assert host and profiling.parse_trace(body["artifact"]) == []
        for bad in ({"duration_ms": 0}, {"duration_ms": 10001},
                    {"duration_ms": "5"}, {"duration_ms": True},
                    {"duration_ms": 5, "dir": 3}):
            assert _post(base, "/v1/debug:profile", bad)[0] == 400
        # a draining replica still profiles
        assert _post(base, "/v1/fleet:drain", {})[0] == 200
        status, body = _post(base, "/v1/debug:profile", {"duration_ms": 5})
        assert status == 200 and body["artifact"].endswith("trace.json")
    finally:
        srv.shutdown()
        srv.server_close()


def test_the_gateway_relays_a_replicas_profile(linear_export):
    gw = fleet.Gateway(heartbeat_timeout_s=30.0)
    gw.start()
    srv = reg = None
    try:
        args, srv, service, _ = _server(
            linear_export, "--fleet", "%s:%d" % gw.registry_addr)
        reg = serve._register_with_fleet(args, srv, service)
        status, body = _post("http://%s:%d" % gw.http_addr,
                             "/v1/debug:profile", {"duration_ms": 20})
        assert status == 200 and body["artifact"].endswith("trace.json")
        status, _ = _post("http://%s:%d" % gw.http_addr,
                          "/v1/debug:profile", {"duration_ms": -1})
        assert status == 400
    finally:
        if reg is not None:
            reg.deregister()
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        gw.stop()
