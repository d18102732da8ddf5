#!/usr/bin/env python3
"""Chip smoke of the PyTorch / CUDA port: builds the hand-written kernels
and drives the port's two main paths — paged continuous-batching serving
of the flagship LM, and its training step — on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one JSON line each; any failure exits non-zero, nothing is
caught and reported as passed):

1. environment: torch / CUDA versions, the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit``, printed raw as well);
2. build: every ``csrc/*.cu`` with nvcc for sm_90a, from a clean build dir;
3. serving kernels against their plain PyTorch versions on the card, at
   the flagship shapes in bf16 (paged decode at FLAGSHIP_DECODE, page
   write and prefill read at FLAGSHIP_PREFILL_KERNEL), with CUDA-event
   times of the kernel, its plain version and one library call, and the
   analytic bound;
4. serving parity: FLAGSHIP_LM_V2 cut to 2 layers, the same seeded
   weights on the card (bf16, kernels) and on the CPU (f32, plain
   versions), one 300-token paged prefill then 8 greedy decode steps;
5. serving main path: full-depth FLAGSHIP_LM_V2 (random bf16 weights
   from a seed) served through the port's ``make_server`` on 127.0.0.1 —
   a concurrent greedy burst of 8 requests, one of them again alone, one
   seeded sampled request twice — with every serving kernel's launch
   count > 0 and the page pool conserved;
6. training kernels the same way as phase 3: flash forward, dq and dk/dv
   at one layer of the flagship train step (B 8, S 1024, H 16, n_kv 8,
   D 128, bf16, causal), fused AdamW over the whole flagship parameter
   tree (f32 p/g/nu, bf16 mu);
7. training parity: FLAGSHIP_LM_V2 cut to 2 layers at full width, B 2 x
   S 256, one ``adamw_fused`` step from the same weights on the card
   (bf16 compute over f32 masters, kernels) and on the CPU (f32, plain
   versions): loss, grad norm and every parameter's update;
8. training main path: full-depth FLAGSHIP_LM_V2 through
   ``make_flagship_step()`` (B 8 x S 1024, adamw_fused, bf16 mu, lr
   3e-4): a warm-up step, then the best of 2 windows of 5 steps, each
   closed by a readback of the loss, then one step under torch.profiler;
   the loss finite and falling, 16 launches of each flash kernel per
   step and at least one AdamW launch per step;
9. the ``kernels`` line (launches from each kernel's own main path);
   then the card line and, last, the ``ok`` line.

Exits 2 without a result when no CUDA device exists or when the port's
package is not beside this file.
"""
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
TOL = 1e-2                          # f32 math, bf16 output rounding
# gradients accumulate over up to 1024 keys or 2 x 1024 queries: bf16
# rounding of values up to ~10 on top of TOL
GRAD_ATOL = 4e-2


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps=25, warmup=3):
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, each with a
    cold L2 (a 64 MB buffer is rewritten first, as the serving path's
    pools are cold) and behind a ~1 ms device spin, so the host enqueues
    the call's launches while the card is still busy and the events time
    the device work, not the host's launch gaps."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def shuffled_table(torch, gen, B, max_pages, n_pages, dev):
    perm = torch.randperm(n_pages - 1, generator=gen).to(torch.int32)
    return perm[:B * max_pages].reshape(B, max_pages).to(dev)


def phase_kernels(torch, F, dev):
    """Kernel vs plain version at the flagship shapes, timed."""
    from tensorflowonspark_tpu_torch.benchmarks import (
        FLAGSHIP_DECODE, FLAGSHIP_LM_V2, FLAGSHIP_PREFILL_KERNEL)
    from tensorflowonspark_tpu_torch.ops import paged_attention as pa
    from tensorflowonspark_tpu_torch.ops import paged_prefill as pp

    H, n_kv = FLAGSHIP_LM_V2["n_heads"], FLAGSHIP_LM_V2["n_kv_heads"]
    Dh = FLAGSHIP_LM_V2["d_model"] // H
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED)
    rows = {}

    # --- kernel 1: paged decode at FLAGSHIP_DECODE -----------------------
    d = FLAGSHIP_DECODE
    B, page, fill = d["n_slots"], d["page_size"], d["fill"]
    max_pages = d["max_seq"] // page
    NP = B * max_pages + 1
    q = torch.randn((B, 1, H, Dh), generator=gen).to(dev, bf16)
    pk = torch.randn((NP, page, n_kv, Dh), generator=gen).to(dev, bf16)
    pv = torch.randn((NP, page, n_kv, Dh), generator=gen).to(dev, bf16)
    table = shuffled_table(torch, gen, B, max_pages, NP, dev)
    lengths = torch.full((B,), fill + 1, dtype=torch.int32, device=dev)
    out = pa.paged_attention(q, pk, pv, table, lengths)
    ref = pa.paged_attention_plain(q, pk, pv, table, lengths)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), atol=TOL, rtol=TOL):
        raise AssertionError(f"paged decode kernel disagrees: {err}")
    n = fill + 1
    kd = pk[table.long()].reshape(B, -1, n_kv, Dh)[:, :n].transpose(1, 2)
    vd = pv[table.long()].reshape(B, -1, n_kv, Dh)[:, :n].transpose(1, 2)
    kd, vd = kd.contiguous(), vd.contiguous()
    qd = q.transpose(1, 2).contiguous()
    b_ms, b_by = bound(q.numel() * 2 * 2 + 2 * B * n * n_kv * Dh * 2,
                       4 * B * H * n * Dh)
    rows["paged_attention"] = dict(
        name="paged_attention", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
        replaces="tensorflowonspark_tpu/ops/paged_attention.py:85",
        max_abs_err=err, tol=TOL,
        ms=time_ms(lambda: pa.paged_attention(q, pk, pv, table, lengths)),
        plain_ms=time_ms(lambda: pa.paged_attention_plain(
            q, pk, pv, table, lengths), reps=20),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
        shapes=dict(B=B, S=1, H=H, n_kv=n_kv, Dh=Dh, page=page,
                    max_pages=max_pages, length=n, dtype="bfloat16"))
    del pk, pv, kd, vd

    # --- kernels 2 and 3 at FLAGSHIP_PREFILL_KERNEL ------------------------
    d = FLAGSHIP_PREFILL_KERNEL
    B, page, fill, S = d["n_slots"], d["page_size"], d["fill"], d["chunk"]
    max_pages = d["max_seq"] // page
    NP = B * max_pages + 1
    sink = NP - 1
    q = torch.randn((B, S, H, Dh), generator=gen).to(dev, bf16)
    k = torch.randn((B, S, n_kv, Dh), generator=gen).to(dev, bf16)
    v = torch.randn((B, S, n_kv, Dh), generator=gen).to(dev, bf16)
    pk = torch.randn((NP, page, n_kv, Dh), generator=gen).to(dev, bf16)
    pv = torch.randn((NP, page, n_kv, Dh), generator=gen).to(dev, bf16)
    table = shuffled_table(torch, gen, B, max_pages, NP, dev)
    starts = torch.full((B,), fill, dtype=torch.int32, device=dev)
    pk2, pv2 = pk.clone(), pv.clone()
    pp._write_pages(k, v, pk, pv, table, starts)
    pp.write_pages_plain(k, v, pk2, pv2, table, starts)
    torch.cuda.synchronize()
    nonsink = torch.arange(NP, device=dev) != sink
    if not (torch.equal(pk[nonsink], pk2[nonsink])
            and torch.equal(pv[nonsink], pv2[nonsink])):
        raise AssertionError("page write kernel: pools differ off the sink")
    flat_k = pk2.view(NP * page, n_kv * Dh)
    flat_v = pv2.view(NP * page, n_kv * Dh)
    pos = starts.long()[:, None] + torch.arange(S, device=dev)
    dest = (torch.gather(table.long(), 1, pos // page) * page
            + pos % page).reshape(-1)
    k2d, v2d = k.reshape(B * S, -1), v.reshape(B * S, -1)

    def library_write():
        flat_k.index_copy_(0, dest, k2d)
        flat_v.index_copy_(0, dest, v2d)

    chunk_bytes = 2 * k.numel() * 2
    b_ms, b_by = bound(2 * chunk_bytes, 0)
    rows["page_write"] = dict(
        name="page_write", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/paged_prefill.cu",
        replaces="tensorflowonspark_tpu/ops/paged_prefill.py:100",
        max_abs_err=0.0, tol=0.0,
        ms=time_ms(lambda: pp._write_pages(k, v, pk, pv, table, starts)),
        plain_ms=time_ms(lambda: pp.write_pages_plain(
            k, v, pk2, pv2, table, starts)),
        library_ms=time_ms(library_write),
        bound_ms=b_ms, bound_by=b_by,
        shapes=dict(B=B, S=S, n_kv=n_kv, Dh=Dh, page=page, start=fill,
                    dtype="bfloat16"))

    out = pp._read_attention(q, k, v, pk, pv, table, starts)
    ref = pp.read_attention_plain(q, k, v, pk, pv, table, starts)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), atol=TOL, rtol=TOL):
        raise AssertionError(f"prefill read kernel disagrees: {err}")
    ctx_k = pk[table.long()].reshape(B, -1, n_kv, Dh)[:, :fill]
    ctx_v = pv[table.long()].reshape(B, -1, n_kv, Dh)[:, :fill]
    kd = torch.cat([ctx_k, k], 1).transpose(1, 2).contiguous()
    vd = torch.cat([ctx_v, v], 1).transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()
    keys = torch.arange(fill + S, device=dev)
    mask = keys[None, :] <= fill + torch.arange(S, device=dev)[:, None]
    visible = B * H * sum(fill + s + 1 for s in range(S))
    b_ms, b_by = bound(2 * q.numel() * 2 + chunk_bytes
                       + 2 * B * fill * n_kv * Dh * 2, 4 * visible * Dh)
    rows["prefill_read"] = dict(
        name="prefill_read", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/paged_prefill.cu",
        replaces="tensorflowonspark_tpu/ops/paged_prefill.py:235",
        max_abs_err=err, tol=TOL,
        ms=time_ms(lambda: pp._read_attention(q, k, v, pk, pv, table,
                                              starts)),
        plain_ms=time_ms(lambda: pp.read_attention_plain(
            q, k, v, pk, pv, table, starts), reps=20),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
        shapes=dict(B=B, S=S, H=H, n_kv=n_kv, Dh=Dh, page=page, start=fill,
                    dtype="bfloat16"))
    return rows


def phase_parity(torch, dev):
    """2-layer full-width flagship: card (bf16, kernels) vs CPU (f32,
    plain versions) on the same weights."""
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_LM_V2
    from tensorflowonspark_tpu_torch.models import decode as dm
    from tensorflowonspark_tpu_torch.models.transformer import (
        build_transformer)

    cfg = dict(FLAGSHIP_LM_V2, n_layers=2, max_seq_len=4096)
    cpu = build_transformer(**dict(cfg, dtype="float32")).eval()
    cpu.reset_parameters(torch.Generator().manual_seed(SEED))
    with torch.device("meta"):
        card = build_transformer(**cfg)
    card.load_state_dict({k: v.to(dev, torch.bfloat16)
                          for k, v in cpu.state_dict().items()},
                         assign=True)
    card.eval()
    plen, steps, page = 300, 8, 64
    prompt = torch.randint(0, cfg["vocab_size"], (1, plen),
                           generator=torch.Generator().manual_seed(SEED))
    n_pages = -(-(plen + steps) // page) + 1
    caches = {}
    for name, model, d in (("card", card, dev), ("cpu", cpu, "cpu")):
        _, cache = dm.init_paged_slot_cache(model, 1, page, n_pages)
        entries = list(range(n_pages - 1))
        dm.set_row_page_table(
            cache, 0, entries + [n_pages - 1] * (4096 // page - len(entries)))
        caches[name] = cache
    results = []
    with torch.no_grad():
        logits = {}
        for name, model, d in (("card", card, dev), ("cpu", cpu, "cpu")):
            logits[name] = dm.slot_prefill_many(
                model, caches[name], prompt.to(d),
                torch.zeros(1, dtype=torch.long, device=d),
                torch.zeros(1, dtype=torch.int32, device=d),
                torch.full((1,), plen, dtype=torch.int32, device=d),
                n_pages - 1)
        for step in range(steps + 1):
            ref = logits["cpu"][0].float()
            got = logits["card"][0].float().cpu()
            tol = 5e-2 * ref.std().item()
            diff = (got - ref).abs().max().item()
            top2 = torch.topk(ref, 2).values
            margin = (top2[0] - top2[1]).item()
            tok = int(torch.argmax(ref))
            agree = int(torch.argmax(got)) == tok
            results.append(dict(step=step, max_abs_diff=diff, tol=tol,
                                top2_margin=margin, token_agrees=agree))
            if diff > tol:
                raise AssertionError(f"full-width parity: step {step} "
                                     f"logits differ by {diff} > {tol}")
            if margin > tol and not agree:
                raise AssertionError(f"full-width parity: step {step} "
                                     "greedy tokens differ")
            if step == steps:
                break
            # both sides take the CPU's greedy token (teacher forcing), so
            # every step compares the same context
            for name, model, d in (("card", card, dev), ("cpu", cpu, "cpu")):
                logits[name] = model(torch.tensor([[tok]], device=d),
                                     caches[name])[:, -1]
    return results


# kernel-name fragments -> the group a training step's device time is
# reported under (first match wins; the rest is "other")
KERNEL_GROUPS = (("tos::flash", "flash kernels"),
                 ("tos::adamw", "adamw kernel"),
                 ("nvjet", "matmul"), ("gemm", "matmul"),
                 ("cutlass", "matmul"), ("xmma", "matmul"),
                 ("reduce", "reductions"), ("norm", "reductions"),
                 ("elementwise", "elementwise"), ("copy", "copies"))


def profile_summary(prof, wall_ms, top=8):
    """Device time of a torch.profiler window: the sum over device-side
    events (kernels, copies; not the host ops that launched them), its
    share of the window's wall time, the top kernels, and the time by
    KERNEL_GROUPS."""
    import torch

    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1000.0
    groups = {}
    for us, _, key in rows:
        name = next((g for frag, g in KERNEL_GROUPS if frag in key.lower()),
                    "other")
        groups[name] = groups.get(name, 0.0) + us / 1000.0
    return dict(wall_ms=wall_ms, device_ms=total_ms,
                device_busy_share=total_ms / wall_ms,
                device_ms_by_group=groups,
                top=[dict(name=k[:80], device_ms=us / 1000.0, count=c)
                     for us, c, k in rows[:top]])


def post_json(url, payload, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def phase_main_path(torch, dev):
    """Full-depth flagship served through make_server on 127.0.0.1."""
    from tensorflowonspark_tpu_torch import export, ops, serve
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_LM_V2
    from tensorflowonspark_tpu_torch.models.transformer import (
        build_transformer)

    cfg = dict(FLAGSHIP_LM_V2, max_seq_len=4096)
    t0 = time.monotonic()
    with torch.device(dev):
        model = build_transformer(**cfg)
    model.reset_parameters(torch.Generator(dev).manual_seed(SEED))
    model.to(torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    export_dir = os.path.join(HERE, "build", "chip_smoke", "export")
    shutil.rmtree(export_dir, ignore_errors=True)
    export.export_saved_model(export_dir, model.state_dict(),
                              builder_kwargs=cfg)
    del model
    torch.cuda.empty_cache()
    args = serve.build_argparser().parse_args([
        "--export_dir", export_dir, "--device", str(dev),
        "--host", "127.0.0.1", "--port", "0",
        "--generate_kv_page_size", "64", "--generate_kv_pages", "512",
        "--generate_slots", "8", "--generate_prefill_chunk", "256",
        "--max_new_tokens_limit", "64"])
    server, service = serve.make_server(args)
    service.generate_service()          # load the export onto the card
    setup_s = time.monotonic() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{server.server_address[1]}"
           "/v1/models/default:generate")
    gen = torch.Generator().manual_seed(SEED + 1)
    lens = [100, 300, 500, 700, 900, 1100, 1300, 1500]
    prompts = [torch.randint(0, cfg["vocab_size"], (n,),
                             generator=gen).tolist() for n in lens]
    max_new = 32
    try:
        ops.reset_launch_counts()
        outs = [None] * len(prompts)
        errors = []

        def client(i):
            try:
                outs[i] = post_json(url, {"inputs": [prompts[i]],
                                          "max_new_tokens": max_new,
                                          "temperature": 0.0})["outputs"][0]
            except Exception as e:  # re-raised below, after the join
                errors.append(e)

        t_burst = time.monotonic()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.monotonic() - t_burst
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"burst failed: {errors}")
        for p, o in zip(prompts, outs):
            if o[:len(p)] != p or len(o) != len(p) + max_new:
                raise AssertionError("burst output is not prompt + new")
        # the solo request runs under torch.profiler: device busy share
        # of its wall time and where the device time goes
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t_solo = time.monotonic()
            solo = post_json(url, {"inputs": [prompts[3]],
                                   "max_new_tokens": max_new})["outputs"][0]
            solo_ms = (time.monotonic() - t_solo) * 1000.0
        profile = profile_summary(prof, solo_ms)
        if solo != outs[3]:
            raise AssertionError("solo answer differs from its burst answer")
        sampled = {"inputs": [prompts[1]], "max_new_tokens": max_new,
                   "temperature": 0.8, "top_k": 50, "top_p": 0.95,
                   "seed": 1234}
        s1 = post_json(url, sampled)["outputs"][0]
        s2 = post_json(url, sampled)["outputs"][0]
        if s1 != s2:
            raise AssertionError("seeded sampled request did not repeat")
        launches = ops.launch_counts(ops.SERVING_KERNELS)
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel never launched: {launches}")
        batcher = service.generate_service().batcher
        stats = batcher.stats()
        free = list(batcher._free_pages)
        owned = [p for pages in batcher._row_pages if pages for p in pages]
        if (len(set(free)) != len(free) or batcher._sink in free
                or sorted(free + owned) != list(range(batcher._total_pages))):
            raise AssertionError("the page pool does not conserve its pages")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        shutil.rmtree(export_dir, ignore_errors=True)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    new_tokens = len(prompts) * max_new
    return launches, dict(
        params=n_params, layers=cfg["n_layers"], setup_s=setup_s,
        burst_requests=len(prompts), prompt_tokens=sum(lens),
        burst_s=burst_s, burst_new_tokens_per_s=new_tokens / burst_s,
        ttft_mean_ms=1000.0 * stats["ttft_sum_s"] / stats["ttft_count"],
        decode_step_ms=stats["decode_step_ms_mean"],
        decode_steps=stats["decode_steps"],
        prefill_dispatches=stats["prefill_dispatches"],
        requests_served=stats["requests_served"], launches=launches,
        solo_profile=profile)


def phase_train_kernels(torch, F, dev):
    """Kernels 4-7 against their plain versions at the flagship training
    shapes, timed."""
    from tensorflowonspark_tpu_torch.benchmarks import (
        FLAGSHIP_BATCH, FLAGSHIP_LM_V2, FLAGSHIP_MU_DTYPE)
    from tensorflowonspark_tpu_torch.models.transformer import (
        build_transformer)
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.ops import fused_optim as fo
    from tensorflowonspark_tpu_torch.optim import make_optimizer

    B, S = FLAGSHIP_BATCH, FLAGSHIP_LM_V2["max_seq_len"]
    H, n_kv = FLAGSHIP_LM_V2["n_heads"], FLAGSHIP_LM_V2["n_kv_heads"]
    D = FLAGSHIP_LM_V2["d_model"] // H
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 2)
    q = torch.randn((B, S, H, D), generator=gen).to(dev, bf16)
    k = torch.randn((B, S, n_kv, D), generator=gen).to(dev, bf16)
    v = torch.randn((B, S, n_kv, D), generator=gen).to(dev, bf16)
    do = torch.randn((B, S, H, D), generator=gen).to(dev, bf16)
    shapes = dict(B=B, S=S, H=H, n_kv=n_kv, D=D, causal=True,
                  dtype="bfloat16")
    rows = {}

    def compare(name, got, want, atol):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), atol=atol,
                              rtol=TOL):
            raise AssertionError(f"{name} kernel disagrees: {err}")
        return err

    # --- kernel 4: flash forward with its LSE (the training forward) -----
    out, lse = fa.flash_fwd(q, k, v, True)
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, True)
    err = compare("flash forward", out, ref, TOL)
    lse_err = compare("flash forward lse", lse, ref_lse, TOL)
    # the backward rows take the plain forward's out and lse as inputs
    delta = torch.einsum("bshd,bshd->bhs", do.float(), ref.float())
    del out, lse
    visible = B * H * S * (S + 1) // 2
    qb, kvb, rowb = q.numel() * 2, k.numel() * 2, B * H * S * 4
    qd, kd, vd = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    b_ms, b_by = bound(2 * qb + 2 * kvb + rowb, 4 * visible * D)
    rows["flash_fwd"] = dict(
        name="flash_fwd", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/flash_attention.cu",
        replaces="tensorflowonspark_tpu/ops/flash_attention.py:56",
        max_abs_err=err, lse_max_abs_err=lse_err, tol=TOL,
        ms=time_ms(lambda: fa.flash_fwd(q, k, v, True)),
        plain_ms=time_ms(lambda: fa.flash_fwd_plain(q, k, v, True), reps=5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, is_causal=True, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by, shapes=shapes)

    # library backward: scaled_dot_product_attention's autograd, which
    # computes dq, dk and dv together (both backward rows carry it)
    leaves = [t.detach().requires_grad_(True) for t in (qd, kd, vd)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
    lib_g = do.transpose(1, 2).contiguous()
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, leaves, lib_g, retain_graph=True))
    del leaves, lib_out, lib_g, qd, kd, vd

    # --- kernel 5: dq ------------------------------------------------------
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, True)
    want = fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, True)
    err = compare("flash dq", dq, want, GRAD_ATOL)
    del dq, want
    b_ms, b_by = bound(3 * qb + 2 * kvb + 2 * rowb, 6 * visible * D)
    rows["flash_bwd_dq"] = dict(
        name="flash_bwd_dq", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/flash_attention.cu",
        replaces="tensorflowonspark_tpu/ops/flash_attention.py:116",
        max_abs_err=err, tol=GRAD_ATOL,
        ms=time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, ref_lse, delta,
                                           True)),
        plain_ms=time_ms(lambda: fa.flash_bwd_dq_plain(
            q, k, v, do, ref_lse, delta, True), reps=5),
        library_ms=lib_bwd_ms, library_covers="dq+dk+dv",
        bound_ms=b_ms, bound_by=b_by, shapes=shapes)

    # --- kernel 6: narrow dk/dv ---------------------------------------------
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, True)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta,
                                              True)
    err = max(compare("flash dk", dk, want_dk, GRAD_ATOL),
              compare("flash dv", dv, want_dv, GRAD_ATOL))
    del dk, dv, want_dk, want_dv
    b_ms, b_by = bound(2 * qb + 4 * kvb + 2 * rowb, 8 * visible * D)
    rows["flash_bwd_dkv"] = dict(
        name="flash_bwd_dkv", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/flash_attention.cu",
        replaces="tensorflowonspark_tpu/ops/flash_attention.py:157",
        max_abs_err=err, tol=GRAD_ATOL,
        ms=time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta,
                                            True)),
        plain_ms=time_ms(lambda: fa.flash_bwd_dkv_plain(
            q, k, v, do, ref_lse, delta, True), reps=5),
        library_ms=lib_bwd_ms, library_covers="dq+dk+dv",
        bound_ms=b_ms, bound_by=b_by, shapes=shapes)
    del q, k, v, do, ref, ref_lse, delta
    torch.cuda.empty_cache()

    # --- kernel 7: fused AdamW over the whole flagship parameter tree ------
    with torch.device("meta"):
        tree = build_transformer(**FLAGSHIP_LM_V2)
    shapes_of = {n: p.shape for n, p in tree.named_parameters()}
    cgen = torch.Generator(dev).manual_seed(SEED + 3)
    params = {n: torch.randn(s, device=dev, generator=cgen)
              for n, s in shapes_of.items()}
    grads = {n: torch.randn(s, device=dev, generator=cgen)
             for n, s in shapes_of.items()}
    opt, _ = make_optimizer("adamw_fused", learning_rate=3e-4,
                            mu_dtype=FLAGSHIP_MU_DTYPE)
    state = opt.init(params)
    for n in params:            # moments of a run in progress
        state.mu[n].copy_(0.1 * grads[n])
        state.nu[n].copy_(0.01 * grads[n] * grads[n])
    n_params = sum(p.numel() for p in params.values())
    scal = fo._scalars(lambda c: torch.full_like(c, 3e-4, dtype=torch.float32),
                       state.count, None, 0.9, 0.999, grads)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.0, write_param=True)
    err = 0.0
    for n, g in grads.items():
        want = fo.adamw_plain(g, params[n], state.mu[n], state.nu[n], scal,
                              **kw)
        fo._adamw(g, params[n], state.mu[n], state.nu[n], scal, params[n],
                  **kw)
        torch.cuda.synchronize()
        for got, ref_t, rtol in ((params[n], want[0], 1e-6),
                                 (state.mu[n], want[1], 8e-3),
                                 (state.nu[n], want[2], 1e-6)):
            if not torch.allclose(got.float(), ref_t.float(), atol=1e-6,
                                  rtol=rtol):
                raise AssertionError(f"AdamW kernel disagrees on {n}")
        err = max(err, (params[n] - want[0]).abs().max().item())
        del want

    def plain_tree():
        for n, g in grads.items():
            fo.adamw_plain(g, params[n], state.mu[n], state.nu[n], scal,
                           **kw)

    adamw_ms = time_ms(lambda: opt.apply(grads, state, params), reps=10)
    adamw_plain_ms = time_ms(plain_tree, reps=3)
    b_ms, b_by = bound(n_params * (3 * 4 + 2) + n_params * (2 * 4 + 2), 0)
    del state
    torch.cuda.empty_cache()
    lib_params = [torch.nn.Parameter(p) for p in params.values()]
    for p, g in zip(lib_params, grads.values()):
        p.grad = g
    lib_opt = torch.optim.AdamW(lib_params, lr=3e-4, weight_decay=0.0,
                                fused=True)
    library_ms = time_ms(lib_opt.step, reps=10)
    rows["adamw"] = dict(
        name="adamw", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/fused_optim.cu",
        replaces="tensorflowonspark_tpu/ops/fused_optim.py:107",
        max_abs_err=err, tol=1e-6, ms=adamw_ms, plain_ms=adamw_plain_ms,
        library_ms=library_ms, library_note="torch.optim.AdamW(fused=True), "
        "f32 mu", bound_ms=b_ms, bound_by=b_by,
        shapes=dict(params=n_params, leaves=len(params), p="float32",
                    g="float32", mu=FLAGSHIP_MU_DTYPE, nu="float32"))
    del lib_opt, lib_params, params, grads
    torch.cuda.empty_cache()
    return rows


def phase_train_parity(torch, dev):
    """One adamw_fused step of the 2-layer full-width flagship: card
    (bf16 compute over f32 masters, kernels) vs CPU (f32, plain
    versions) from the same weights."""
    from tensorflowonspark_tpu_torch.benchmarks import (
        FLAGSHIP_LM_V2, make_flagship_step)

    cfg = dict(FLAGSHIP_LM_V2, n_layers=2, max_seq_len=256)
    cpu_step, cpu_state, tokens, _ = make_flagship_step(
        2, None, dict(cfg, dtype="float32", attention_impl="flash"),
        device="cpu")
    step, state, card_tokens, _ = make_flagship_step(2, None, cfg,
                                                     device=dev)
    state.params.load_state_dict(cpu_state.params.state_dict())
    before = {n: t.detach().clone()
              for n, t in cpu_state.params.state_dict().items()}
    cpu_state, want = cpu_step(cpu_state, tokens, None)
    state, got = step(state, card_tokens, None)
    lr = 3e-4
    loss = (got["loss"].item(), want["loss"].item())
    norm = (got["grad_norm"].item(), want["grad_norm"].item())
    # bf16 activations keep ~3 significant digits: loss within 1%, the
    # gradient norm within 5%
    if abs(loss[0] - loss[1]) > 1e-2 * abs(loss[1]):
        raise AssertionError(f"train parity: loss card/cpu {loss}")
    if abs(norm[0] - norm[1]) > 5e-2 * abs(norm[1]):
        raise AssertionError(f"train parity: grad norm card/cpu {norm}")
    # the first AdamW step moves each element by lr * g / (|g| + eps),
    # about +-lr: updates agree where the two agree on the gradient's
    # sign; only elements with a gradient near 0 may turn
    cpu_params = cpu_state.params.state_dict()
    agree, total, worst = 0, 0, (1.0, None)
    for n, t in state.params.state_dict().items():
        d_card = t.detach().cpu() - before[n]
        d_cpu = cpu_params[n] - before[n]
        if (d_card - d_cpu).abs().max().item() > 2 * lr + 1e-6:
            raise AssertionError(f"train parity: {n} moved more than 2 lr")
        same = ((d_card - d_cpu).abs() <= lr / 2).sum().item()
        agree += same
        total += t.numel()
        if same / t.numel() < worst[0]:
            worst = (same / t.numel(), n)
    if agree / total < 0.95 or worst[0] < 0.9:
        raise AssertionError(f"train parity: updates agree on "
                             f"{agree / total:.4f} (worst {worst})")
    return dict(layers=2, batch=2, seq=256, loss_card=loss[0],
                loss_cpu=loss[1], grad_norm_card=norm[0],
                grad_norm_cpu=norm[1], update_agreement=agree / total,
                worst_leaf_agreement=worst[0], worst_leaf=worst[1],
                tol=dict(loss_rel=1e-2, grad_norm_rel=5e-2,
                         update_agreement=0.95, leaf_agreement=0.9))


def phase_train_main(torch, dev):
    """Full-depth flagship train step on the card, timed."""
    from tensorflowonspark_tpu_torch import ops
    from tensorflowonspark_tpu_torch.benchmarks import (
        FLAGSHIP_LM_V2, make_flagship_step)

    t0 = time.monotonic()
    step, state, tokens, n_params = make_flagship_step(device=dev)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    B, S = tokens.shape[0], tokens.shape[1] - 1
    layers = FLAGSHIP_LM_V2["n_layers"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses = []
    state, m = step(state, tokens, None)             # warm-up
    losses.append(m["loss"])
    windows = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.monotonic()
        for _ in range(5):
            state, m = step(state, tokens, None)
            losses.append(m["loss"])
        m["loss"].item()              # the readback closes the window
        windows.append((time.monotonic() - t) * 1000.0 / 5)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        state, m = step(state, tokens, None)
        losses.append(m["loss"])
        m["loss"].item()
        profiled_ms = (time.monotonic() - t) * 1000.0
    launches = ops.launch_counts(ops.TRAINING_KERNELS)
    steps = len(losses)
    losses = [x.item() for x in losses]
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"training loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] != layers * steps:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{steps} steps of {layers} layers")
    if launches["adamw"] < steps:
        raise AssertionError(f"adamw: {launches['adamw']} launches in "
                             f"{steps} steps")
    step_ms = min(windows)
    return launches, dict(
        params=n_params, layers=layers, batch=B, seq=S, setup_s=setup_s,
        steps=steps, window_step_ms=windows, step_ms=step_ms,
        tokens_per_s=B * S / (step_ms / 1000.0),
        mfu=6.0 * n_params * B * S / (step_ms / 1000.0)
        / PEAK_BF16_FLOP_PER_S,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        losses=losses, launches=launches,
        step_profile=profile_summary(prof, profiled_ms, top=12))


def main():
    try:
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        print(f"chip_smoke: torch unavailable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "tensorflowonspark_tpu_torch")):
        print("chip_smoke: the port's package is not beside this file",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = nvidia_smi()
    print(card, flush=True)
    emit("environment", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], nvidia_smi=card,
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    from tensorflowonspark_tpu_torch.ops import _build
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    info = _build.build(force=True)
    ptxas = {src: [ln.strip() for ln in out.splitlines()
                   if "registers" in ln or "spill" in ln]
             for src, out in info["ptxas"].items()}
    emit("build", seconds=info["seconds"], library=_build.LIBRARY,
         ptxas=ptxas)

    rows = phase_kernels(torch, F, dev)
    for row in rows.values():
        emit("kernel", **row)
    torch.cuda.empty_cache()

    parity = phase_parity(torch, dev)
    emit("parity", steps=parity)
    torch.cuda.empty_cache()

    launches, main_path = phase_main_path(torch, dev)
    emit("main_path", nvidia_smi=card, **main_path)
    torch.cuda.empty_cache()

    train_rows = phase_train_kernels(torch, F, dev)
    for row in train_rows.values():
        emit("kernel", **row)
    rows.update(train_rows)

    emit("train_parity", **phase_train_parity(torch, dev))
    torch.cuda.empty_cache()

    train_launches, train_main = phase_train_main(torch, dev)
    emit("train_main_path", nvidia_smi=card, **train_main)
    launches.update(train_launches)

    kernels = []
    for name, row in rows.items():
        kernels.append({key: row[key] for key in (
            "name", "route", "source", "replaces")}
            | {"launches": launches[name]}
            | {key: row[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
