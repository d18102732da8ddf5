"""Page-granular kv migration of the port (``kvtransfer``, the batcher's
freeze / resume / replay, the HTTP surface), against the JAX package.

- the wire: int8 payloads with f32 scale blocks over a ragged page
  count, bf16 and empty blocks, a snapshot without blocks, all round
  trip bit for bit; out-of-order and short chunks and ``err`` frames
  are refused; a page server's ticket serves until it is released;
- ``wire_snapshot``: the same greedy session frozen at its first decode
  tick on the JAX batcher and on the port's gives meta equal key for
  key and blocks of the same names, shapes and dtypes, equal within
  the stated tolerance: the paged pool in bf16 (2e-2 absolute: two
  implementations' bf16 rounding), the int8 pool (payload within 1,
  scales within 1e-5 relative) and the dense cache (f32, 1e-5);
- a greedy burst migrated mid-decode through a page server gives the
  JAX package's migrated burst's tokens and the tokens of a run without
  migration; sampled rows (seeded) and penalised rows equal the port's
  run without migration bit for bit on the paged, int8 and dense
  layouts; a replay of a token record goes on with the same tokens;
- the HTTP surface on the CPU: ``X-Fleet-Migrate-To`` hands a stream
  from a ``--role prefill`` replica to a ``--role decode`` one,
  ``POST /v1/kv:export`` moves a live burst (every session lands),
  ``:resume`` refuses a snapshot of another layout with a 400, which
  the engine takes as final (``ResumeRefused``) and rolls back; a
  replica with a draft model refuses resumes; ``make_server`` refuses
  ``--role prefill`` with ``--draft_export_dir``.
"""
import json
import socket
import threading

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import kvtransfer as jax_kvtransfer
from tensorflowonspark_tpu import serve as jax_serve
from tensorflowonspark_tpu_torch import kvtransfer, serve

import torch_replica_lm as lm_mod

ENGINE = dict(n_slots=4, read_chunk=2, prefill_chunk=16)
PAGED = dict(kv_page_size=8, kv_pages=40)


def _round_trip(meta, blocks):
    a, b = socket.socketpair()
    box = {}

    def recv():
        box["out"] = kvtransfer.read_snapshot(kvtransfer.KvSocket(), b)

    t = threading.Thread(target=recv)
    t.start()
    try:
        kvtransfer.write_snapshot(kvtransfer.KvSocket(), a, meta, blocks)
        t.join(timeout=30)
        assert not t.is_alive()
    finally:
        a.close()
        b.close()
    return box["out"]


def test_wire_round_trips_int8_scales_bf16_and_empty_blocks():
    rs = np.random.RandomState(0)
    blocks = {
        "layer_0/attn/pages_key": torch.from_numpy(
            rs.randint(-128, 127, (3, 8, 2, 4)).astype(np.int8)),
        "layer_0/attn/pages_key_scale": rs.rand(3, 8, 2).astype(np.float32),
        "bf16": torch.randn(2, 5, generator=torch.Generator().manual_seed(
            1)).to(torch.bfloat16),
        "empty": torch.zeros((0, 4, 2), dtype=torch.bfloat16),
    }
    meta = {"version": 1, "kind": "paged", "seq": [1, 2, 3], "plen": 2,
            "eos": None, "stops": [[4, 5]]}
    old_chunk = kvtransfer.CHUNK_BYTES
    kvtransfer.CHUNK_BYTES = 64             # many chunks per block
    try:
        meta2, blocks2 = _round_trip(meta, blocks)
    finally:
        kvtransfer.CHUNK_BYTES = old_chunk
    assert meta2 == meta and set(blocks2) == set(blocks)
    for name, arr in blocks.items():
        want = torch.as_tensor(arr)
        assert blocks2[name].dtype == want.dtype
        assert blocks2[name].shape == want.shape
        assert torch.equal(blocks2[name], want)
    assert _round_trip({"empty": True}, {}) == ({"empty": True}, {})
    assert kvtransfer.dtype_name(torch.bfloat16) == "bfloat16"
    with pytest.raises(ValueError, match="unknown kv block dtype"):
        kvtransfer.torch_dtype("complex_thing")


def test_wire_refuses_out_of_order_short_and_error_frames():
    cases = [
        [({"kind": "header", "version": 1, "meta": {}, "blocks": [
            {"name": "k", "dtype": "float32", "shape": [2],
             "nbytes": 8}]}, b""),
         ({"kind": "block", "i": 0, "off": 4}, b"\0" * 4)],
        [({"kind": "header", "version": 1, "meta": {}, "blocks": [
            {"name": "k", "dtype": "float32", "shape": [2],
             "nbytes": 8}]}, b""),
         ({"kind": "block", "i": 0, "off": 0}, b"\0" * 4),
         ({"kind": "end"}, b"")],
        [({"kind": "err", "error": "unknown kv ticket"}, b"")],
        [({"kind": "header", "version": 2}, b"")],
    ]
    for frames, match in zip(cases, ("out-of-order", "short block",
                                     "unknown kv ticket", "bad kv")):
        a, b = socket.socketpair()
        try:
            for head, data in frames:
                kvtransfer.KvSocket().send(a, head, data)
            with pytest.raises(ValueError, match=match):
                kvtransfer.read_snapshot(kvtransfer.KvSocket(), b)
        finally:
            a.close()
            b.close()


def test_page_server_tickets_serve_until_released():
    server = kvtransfer.PageServer()
    try:
        blocks = {"k": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
        ticket = server.register({"seq": [1]}, blocks)
        for _ in range(2):                   # a retry pulls again
            meta, got = kvtransfer.pull_snapshot(server.addr, ticket)
            assert meta == {"seq": [1]} and torch.equal(got["k"],
                                                        blocks["k"])
        server.release(ticket)
        with pytest.raises(ValueError, match="unknown kv ticket"):
            kvtransfer.pull_snapshot(server.addr, ticket)
        with pytest.raises(ValueError, match="no kv:prefix provider"):
            kvtransfer.pull_prefix(server.addr, [1, 2], 8)
    finally:
        server.close()


def _freeze_first_tick(b, prompt, n):
    """Freeze a greedy session at its first decode tick (the request is
    set before the tick lands): returns (meta, blocks), rolled back."""
    h = b.submit(prompt, n)
    frozen = b.freeze_session(h, timeout_s=120)
    assert frozen is not None
    mod = jax_kvtransfer if isinstance(b, jax_serve.ContinuousBatcher) \
        else kvtransfer
    meta, blocks = mod.wire_snapshot(frozen, "default", b.kv_page_size)
    blocks = {k: np.asarray(v.float() if isinstance(v, torch.Tensor)
                            and v.dtype == torch.bfloat16 else v,
                            dtype=np.float32 if v.dtype != np.int8
                            and v.dtype != torch.int8 else np.int8)
              for k, v in blocks.items()}
    dtypes = {k: str(v.dtype).rpartition(".")[2]
              for k, v in mod.wire_snapshot(frozen, "default",
                                            b.kv_page_size)[1].items()}
    assert b.rollback_migration(frozen)
    assert h.result(timeout=300)[:len(meta["seq"])] == meta["seq"]
    return meta, blocks, dtypes


@pytest.mark.parametrize("layout,dtype,kw,tol", [
    ("paged-bf16", "bfloat16", PAGED, 2e-2),
    ("paged-int8", "float32", dict(PAGED, kv_dtype="int8"), 1e-5),
    ("dense", "float32", {}, 1e-5)])
def test_wire_snapshot_meta_and_blocks_equal_jax(layout, dtype, kw, tol):
    jm, params, pm = lm_mod.tiny_lm(dtype)
    prompt = lm_mod.prompts(1, lo=19, hi=20, seed=31)[0]
    engine = dict(ENGINE, n_slots=2, prefill_chunk=32)   # one bucket
    jb = jax_serve.ContinuousBatcher(jm, params, **engine, **kw)
    try:
        want_meta, want, want_dt = _freeze_first_tick(jb, prompt, 6)
    finally:
        jb.stop()
    b = serve.ContinuousBatcher(pm, device="cpu", **engine, **kw)
    try:
        got_meta, got, got_dt = _freeze_first_tick(b, prompt, 6)
    finally:
        b.stop()
    assert got_meta == want_meta
    assert list(got_meta) == list(want_meta)
    assert got_meta["seq"][:-1] == prompt
    assert got_dt == want_dt and set(got) == set(want)
    n_pos = len(prompt)             # committed kv positions at the cut
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if layout.startswith("paged"):   # [pages, page, ...] -> positions
            g = g.reshape((-1,) + g.shape[2:])[:n_pos]
            w = w.reshape((-1,) + w.shape[2:])[:n_pos]
        else:
            g, w = g[:n_pos], w[:n_pos]
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
        elif name.endswith("_scale"):
            np.testing.assert_allclose(g, w, rtol=tol, atol=1e-7)
        else:
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


def _migrate_burst(src, dst, prompts, n, mod, **kw):
    """Every session frozen after its first token, shipped through a
    page server, resumed on `dst`: the outputs."""
    hs = [src.submit(p, n, **kw) for p in prompts]
    for h in hs:
        h.tokens.get(timeout=300)
    for h in hs:     # every cut requested at once, each at its next tick
        h.migrate_requested.set()
    server = mod.PageServer()
    moved = []
    try:
        for h in hs:
            frozen = src.freeze_session(h, timeout_s=120)
            assert frozen is not None
            meta, blocks = mod.wire_snapshot(frozen, "m", src.kv_page_size)
            ticket = server.register(meta, blocks)
            meta2, blocks2 = mod.pull_snapshot(server.addr, ticket)
            h2, installed = dst.submit_resume(meta2, blocks2)
            assert installed.wait(300)
            src.complete_migration(frozen)
            moved.append(h2)
    finally:
        server.close()
    return [h.result(timeout=300) for h in moved]


def test_greedy_burst_migrated_mid_decode_equals_jax_and_unmoved():
    jm, params, pm = lm_mod.tiny_lm()
    prompts = lm_mod.prompts(3, seed=41)
    kw = dict(ENGINE, **PAGED)
    jsrc = jax_serve.ContinuousBatcher(jm, params, **kw)
    jdst = jax_serve.ContinuousBatcher(jm, params, **kw)
    try:
        want = _migrate_burst(jsrc, jdst, prompts, 30, jax_kvtransfer)
        assert jdst.stats()["migrations_resumed"] == 3
    finally:
        jsrc.stop()
        jdst.stop()
    src = serve.ContinuousBatcher(pm, device="cpu", **kw)
    dst = serve.ContinuousBatcher(pm, device="cpu", **kw)
    try:
        got = _migrate_burst(src, dst, prompts, 30, kvtransfer)
        s, d = src.stats(), dst.stats()
        assert (s["migrations_completed"], d["migrations_resumed"]) == (3, 3)
        assert s["kv_pages_exported"] == d["kv_pages_imported"] > 0
        assert lm_mod.conserved(src) and lm_mod.conserved(dst)
        assert s["kv_pages_free"] + s["prefix_pages_cached"] == 40
    finally:
        src.stop()
        dst.stop()
    assert got == want
    assert got == [lm_mod.solo(pm, p, 30) for p in prompts]


@pytest.mark.parametrize("layout", ["paged", "int8", "dense"])
def test_sampled_rows_go_on_bit_for_bit(layout):
    _, _, pm = lm_mod.tiny_lm()
    kw = {"paged": PAGED, "int8": dict(PAGED, kv_dtype="int8"),
          "dense": {}}[layout]
    prompts = lm_mod.prompts(3, seed=43)
    sampling = dict(temperature=0.9, seed=7, top_k=20)
    runs = []
    for migrate in (False, True):
        src = serve.ContinuousBatcher(pm, device="cpu", **ENGINE, **kw)
        dst = serve.ContinuousBatcher(pm, device="cpu", **ENGINE, **kw)
        try:
            if migrate:
                out = _migrate_burst(src, dst, prompts, 14, kvtransfer,
                                     **sampling)
                out += _migrate_burst(src, dst, prompts[:1], 10, kvtransfer,
                                      repetition_penalty=1.3)
            else:
                out = [src.submit(p, 14, **sampling).result(timeout=300)
                       for p in prompts]
                out.append(src.submit(prompts[0], 10, repetition_penalty=1.3)
                           .result(timeout=300))
        finally:
            src.stop()
            dst.stop()
        runs.append(out)
    assert runs[1] == runs[0]


def test_replay_of_a_token_record_goes_on_with_the_same_tokens():
    _, _, pm = lm_mod.tiny_lm()
    prompt = lm_mod.prompts(1, seed=47)[0]
    b = serve.ContinuousBatcher(pm, device="cpu", **ENGINE, **PAGED)
    try:
        for kw in ({}, dict(temperature=0.8, seed=3)):
            full = b.submit(prompt, 12, **kw).result(timeout=300)
            cut = len(prompt) + 5
            meta = {"seq": full[:cut], "plen": len(prompt), "max_new": 12,
                    "remaining": 12 - 5, "temp": kw.get("temperature", 0.0),
                    "seed": kw.get("seed", 0)}
            h, installed = b.submit_replay(meta)
            assert h.result(timeout=300) == full
            assert installed.is_set()
        assert b.stats()["replays_resumed"] == 2
    finally:
        b.stop()


def test_submit_resume_validates_eagerly():
    _, _, pm = lm_mod.tiny_lm()
    b = serve.ContinuousBatcher(pm, device="cpu", **ENGINE, **PAGED)
    try:
        h = b.submit([1, 2, 3, 4, 5, 6, 7, 8, 9], 8)
        frozen = b.freeze_session(h, timeout_s=120)
        meta, blocks = kvtransfer.wire_snapshot(frozen, "m", 8)
        bad = [(dict(meta, kind="dense"), blocks, "layout mismatch"),
               (dict(meta, page_size=16), blocks, "page size mismatch"),
               (dict(meta, remaining=1), blocks, "inconsistent budget"),
               (dict(meta, n_pages=3), blocks, "ships 3 pages"),
               (dict(meta, seq=[99] * 10), blocks, "out of vocab"),
               (meta, {k: v for k, v in list(blocks.items())[1:]},
                "missing kv blocks"),
               (meta, {k: v[:, :4] for k, v in blocks.items()},
                "has shape")]
        for m, bl, match in bad:
            with pytest.raises(ValueError, match=match):
                b.submit_resume(m, bl)
        assert b.rollback_migration(frozen)
        assert h.result(timeout=300) == lm_mod.solo(pm, [1, 2, 3, 4, 5, 6,
                                                         7, 8, 9], 8)
    finally:
        b.stop()


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    return lm_mod.export_lm(tmp_path_factory.mktemp("kvtransfer_lm"))


def test_prefill_role_hands_streams_to_a_decode_replica(export_dir):
    _, _, pm = lm_mod.tiny_lm()
    flags = ("--generate_kv_page_size", "8", "--generate_kv_pages", "40")
    with lm_mod.Replica(export_dir, "--role", "prefill", *flags) as a, \
            lm_mod.Replica(export_dir, "--role", "decode", *flags) as d:
        prompt = lm_mod.prompts(1, seed=53)[0]
        events = a.generate(
            {"inputs": [prompt], "max_new_tokens": 16, "stream": True,
             "temperature": 0.7, "seed": 5},
            headers={"X-Fleet-Migrate-To": f"127.0.0.1:{d.port}"})
        toks = [e["token"] for e in events if "token" in e]
        assert events[-1]["output"] == prompt + toks
        assert events[-1]["output"] == a.generate(
            {"inputs": [prompt], "max_new_tokens": 16, "temperature": 0.7,
             "seed": 5})[0]
        sa, sd = a.batcher.stats(), d.batcher.stats()
        assert (sa["migrations_completed"], sd["migrations_resumed"]) == (1,
                                                                         1)
        assert sa["migrations_failed"] == 0
        meta = json.loads(a.get("/v1/models/default")[2])
        assert meta["model"]["role"] == "prefill"
        # kv:export of a live burst: every session lands, outputs equal
        prompts = lm_mod.prompts(3, seed=54)
        box = {}
        t = threading.Thread(target=lambda: box.update(out=a.generate(
            {"inputs": prompts, "max_new_tokens": 40})))
        t.start()
        b = a.batcher
        while sum(s is not None for s in b._slots) < 3 and t.is_alive():
            pass
        status, _, raw = a.post("/v1/kv:export", {"dest": {
            "host": "127.0.0.1", "port": d.port}, "timeout_s": 60})
        t.join(timeout=300)
        res = json.loads(raw)
        assert status == 200 and res["sessions"] == 3
        assert res["migrated"] + res["completed_locally"] == 3
        assert res["failed"] == 0
        assert all(r["freeze_to_ack_ms"] > 0 for r in res["details"]
                   if r.get("migrated"))
        assert box["out"] == [lm_mod.solo(pm, p, 40) for p in prompts]
        assert a.post("/v1/kv:export", {"dest": {"host": "h"}})[0] == 400


def test_a_refused_resume_rolls_back_to_the_source(export_dir):
    _, _, pm = lm_mod.tiny_lm()
    with lm_mod.Replica(export_dir, "--generate_kv_page_size", "8",
                        "--generate_kv_pages", "40") as a, \
            lm_mod.Replica(export_dir) as dense:
        prompt = lm_mod.prompts(1, seed=57)[0]
        h = a.batcher.submit(prompt, 20)
        h.tokens.get(timeout=300)
        eng = a.service.migration_engine()
        res = eng.migrate(h, ("127.0.0.1", dense.port), timeout_s=60,
                          retries=3)
        assert not res["migrated"] and "HTTP 400" in res["error"]
        assert h.result(timeout=300) == lm_mod.solo(pm, prompt, 20)
        st = a.batcher.stats()
        assert (st["migrations_started"], st["migrations_failed"],
                st["migrations_completed"]) == (1, 1, 0)
        assert lm_mod.conserved(a.batcher)


def test_a_draft_replica_refuses_resumes(tmp_path, export_dir):
    _, _, pm = lm_mod.tiny_lm()
    b = serve.ContinuousBatcher(pm, device="cpu", draft_model=pm,
                                draft_k=2, **ENGINE)
    try:
        with pytest.raises(ValueError, match="speculative"):
            b.submit_resume({"kind": "dense", "seq": [1, 2], "plen": 1},
                            {})
        with pytest.raises(ValueError, match="speculative"):
            b.freeze_session(serve.SlotHandle())
    finally:
        b.stop()
    args = serve.build_argparser().parse_args([
        "--export_dir", export_dir, "--device", "cpu", "--role", "prefill",
        "--draft_export_dir", export_dir])
    with pytest.raises(ValueError, match="--role prefill/decode"):
        serve.make_server(args)
