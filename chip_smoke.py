#!/usr/bin/env python3
"""Chip smoke of the PyTorch / CUDA port: builds the hand-written kernels
and drives the port's main paths — paged continuous-batching serving of
the flagship LM with bf16, int8 and int4 weights, over a bf16 or an int8
kv pool, of its LayerNorm variant with the fused LayerNorm, its
training step, and that step fed through the cluster runtime — on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (one JSON line each; any failure exits non-zero, nothing is
caught and reported as passed):

1. environment: torch / CUDA versions, the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit``, printed raw as well);
2. build: every ``csrc/*.cu`` with nvcc for sm_90a, from a clean build
   dir; each kernel's registers, shared memory and spill bytes from
   ``-Xptxas -v``, by name, and the run fails if a tensor-core kernel
   (``*_mma_kernel``, ``*_tc_kernel``), a paged decode, page write or
   LayerNorm kernel spills (NO_SPILL); each kernel row below carries the
   figures of its main path's instantiations (``ptxas``); then the
   timer's floor (``launch_floor``: ``time_ms`` of a one-element
   ``zero_()``), which every kernel row carries as ``floor_ms``;
3. serving kernels against their plain PyTorch versions on the card, at
   the flagship shapes in bf16 (paged decode at FLAGSHIP_DECODE, page
   write and prefill read at FLAGSHIP_PREFILL_KERNEL, the page write
   also at a FLAGSHIP_DECODE step under ``shapes``), with CUDA-event
   times of the kernel, its plain version and one library call, and the
   analytic bound; the paged decode also with its decode kernel and its
   split combine timed apart (``kernel_ms``, ``combine_ms``); the prefill
   read (bf16, tensor cores) also with its TFLOP/s and share of the
   bound, and the run fails if its time lies above the CUDA cores' 67
   TFLOP/s f32 line;
4. serving parity: FLAGSHIP_LM_V2 cut to 2 layers, the same seeded
   weights on the card (bf16, kernels) and on the CPU (f32, plain
   versions), one 300-token paged prefill then 8 greedy decode steps;
5. serving main path: full-depth FLAGSHIP_LM_V2 (random f32 master
   weights from a seed, exported once and served at bf16) through the
   port's ``make_server`` on 127.0.0.1 — a concurrent greedy burst of 8
   requests, one of them again alone under torch.profiler, one seeded
   sampled request twice — with every serving kernel's launch count > 0
   and the page pool conserved; each serving run reports its kernels'
   launches by shape (``launches_by_shape``: decode steps and prefill
   dispatches times the launching modules of one forward, and whether
   they add up to the wrapper's count);
5a. quantised kernels (9 and 10) against their plain versions on the
   card in bf16 at FLAGSHIP_QUANT_MATMUL (the ``wi`` shape, and ``wo``
   with K and N swapped, each at a 16-row decode step and a 1024-row
   prefill dispatch), timed like phase 3, with ``F.linear`` on the bf16
   dequantised weight as the library call and the achieved TFLOP/s and
   share of the bound beside each time; quantising the ``wi`` weight on
   the card gives the CPU's bytes;
5b. quantised parity: phase 4 again with int8 and with int4 weights,
   quantised once on the CPU from the f32 masters (card bf16 + kernels,
   CPU f32 + plain versions, the same quantised bytes);
5c. quantised main path: phase 5's export served again with
   ``--generate_quantize int8`` and then ``int4``, the same requests;
   launch counts > 0 for that mode's matmul kernel and kernels 1-3,
   resident weight bytes and ``memory_allocated`` beside the bf16 run;
5d. the int8 kv branch of kernels 1-3 against their plain versions at
   phase 3's shapes (bf16 activations; the page write's payload, scales
   and dequantised chunk bitwise equal to the plain version's on the card
   and on the CPU, at the prefill chunk and at a FLAGSHIP_DECODE step
   (S 1, 16 rows at position 2000), each timed under ``shapes``; the
   decode kernel and combine timed apart; the prefill
   read, on the tensor cores, held to the f32 line as in phase 3), and
   kernel 11 (LayerNorm) at 1024 x 2048 and 8 x 2048
   against its plain version and ``F.layer_norm``, timed like phase 3;
5e. phase 4 again over an int8 kv pool, and for FLAGSHIP_LM (LayerNorm)
   cut to 2 layers with ``fused_ln=True``, held against the CPU at the
   card's bf16 (plain versions), with each one's distance from the f32
   CPU run reported beside;
5f. phase 5's export served again with ``--generate_kv_dtype int8``, and
   with ``--generate_quantize int8 --generate_kv_dtype int8``; then a
   full-depth FLAGSHIP_LM export with ``fused_ln=True`` served like
   phase 5: launch counts > 0 for the int8 kv kernels and for kernel 11,
   the kv pool's resident bytes beside the bf16 run's;
6. training kernels the same way as phase 3: flash forward, dq and dk/dv
   at one layer of the flagship train step (B 8, S 1024, H 16, n_kv 8,
   D 128, bf16, causal; all three on the tensor cores, each checked
   against the f32 line as in phase 3), fused AdamW over the whole
   flagship parameter tree (f32 p/g/nu, bf16 mu);
6b. kernel 8 (fused Lion) over the whole flagship parameter tree (f32
   p/g, bf16 mu), bitwise against its plain version, timed like phase 3
   (no PyTorch call computes Lion: the library column is null);
6c. ``flash_attention_with_lse`` at phase 6's layer and at head_dim 64:
   out, lse, and dq / dk / dv under a random lse cotangent (folded into
   delta before kernels 5 and 6) against the plain versions;
7. training parity: FLAGSHIP_LM_V2 cut to 2 layers at full width, B 2 x
   S 256, one ``adamw_fused`` step from the same weights on the card
   (bf16 compute over f32 masters, kernels) and on the CPU (f32, plain
   versions): loss, grad norm and every parameter's update;
7b. phase 7 again for ``lion_fused``, ``adamw8bit`` (two steps, so that
   the second reads the dequantised int8 moments) and ``adafactor``,
   each with its update tolerance; then one more ``adamw8bit`` update
   from the card's int8 state on the card and on the CPU from the same
   inputs: payloads and scales bitwise, updates within rtol 1e-6;
8. training main path: full-depth FLAGSHIP_LM_V2 through
   ``make_flagship_step()`` (B 8 x S 1024, adamw_fused, bf16 mu, lr
   3e-4): a warm-up step, then the best of 2 windows of 5 steps, each
   closed by a readback of the loss, then one step under torch.profiler;
   the loss finite and falling, 16 launches of each flash kernel per
   step and one AdamW launch per parameter leaf per step;
8b. phase 8 with ``make_flagship_step(optimizer="lion_fused")``: one
   Lion launch per parameter leaf per step;
8c. the full-depth step with ``adamw8bit`` and with ``adafactor`` (built
   with ``make_optimizer(name, learning_rate=3e-4)`` and
   ``make_train_step``: both refuse make_flagship_step's bf16 mu): a
   warm-up step and one window of 3 steps, the loss finite, step ms and
   peak memory beside phase 8's;
10. (after 8c) cluster: a ``gpu_info`` line (in a fresh process that
   never loads torch: its GPU count against ``torch.cuda.device_count()``,
   ``assign_chips(1, 1)`` refused as oversubscription on one GPU,
   ``assign_chips(1, 0)`` giving ``CUDA_VISIBLE_DEVICES=0``), then the
   ``cluster_main_path`` line: ``cluster.run(LocalBackend(1,
   start_method="spawn"), fed_train_fn, num_chips=1)`` trains the
   full-depth flagship step (phase 8's) in the executor's node process
   over 11 batches of 88 seeded token rows pushed in two partitions
   through the shm ring and DataFeed (a warm-up step and 2 windows of 5),
   and ``c.inference`` scores 32 rows with a fresh seeded model
   (kernel 4); every row seen, the ring attached, the executor free of
   torch, 16 launches of each flash kernel and 131 of AdamW a step in the
   node, and fed losses and scores equal, bit for bit, to the same
   seeded work run directly in this process over the same batches; with
   the fed and direct step ms, the feed wait, the feed's rows and MB per
   second of wait, and the spawn-to-first-step seconds;
9. the ``launch_split`` line (the serving kernels' launches by shape,
   each from its own main path); the ``kernels`` line (launches from
   each kernel's own main path: the
   quantised kernels from their serving run, the int8 kv kernels from the
   int8 kv run with bf16 weights, kernel 11 from the fused LayerNorm
   run, kernel 8 from phase 8b); then the card line and, last, the
   ``ok`` line.

Exits 2 without a result when no CUDA device exists or when the port's
package is not beside this file.
"""
import json
import os
import re
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
PEAK_F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
TOL = 1e-2                          # f32 math, bf16 output rounding
# fused-dequant matmuls in bf16: the largest error within this share of
# the largest |plain output| (the JAX package's own kernel tolerance)
QMM_TOL = 2e-2
# gradients accumulate over up to 1024 keys or 2 x 1024 queries: bf16
# rounding of values up to ~10 on top of TOL
GRAD_ATOL = 4e-2
# dk and dv of the late keys sum few queries and are about as small as
# GRAD_ATOL, so each key's row of dk and of dv is also held to this share
# of its reference row's norm (the emulated rounding points of the
# tensor-core backward use about 0.5% at phase 6's layer)
GRAD_ROW_RTOL = 2e-2


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


def launch_floor_ms():
    """The timer's floor: :func:`time_ms` of one launch that does next to
    nothing (a one-element ``zero_()`` on the card), the least any kernel
    row can read."""
    import torch

    one = torch.zeros(1, device="cuda")
    return time_ms(one.zero_)


def bound(nbytes, flops, peak=PEAK_BF16_FLOP_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def tensor_core_check(name, flops, ms, bound_ms):
    """The achieved TFLOP/s and share of the bound of a bf16 kernel that
    runs on the tensor cores; raises when its time lies above the line
    of the CUDA cores' f32 rate (``flops`` at 67 TFLOP/s), which only
    the tensor cores can beat."""
    line_ms = flops / PEAK_F32_FLOP_PER_S * 1e3
    if ms > line_ms:
        raise AssertionError(
            f"{name}: {ms:.4f} ms lies above the CUDA cores' f32 line "
            f"({line_ms:.4f} ms for {flops / 1e9:.2f} GFLOP)")
    return dict(tflops=flops / ms / 1e9, share_of_bound=bound_ms / ms,
                f32_line_ms=line_ms)


def ptxas_kernels(reports):
    """Each kernel's ``-Xptxas -v`` figures from the sources' build
    reports: ``{mangled name: dict(source, registers, smem, spill_stores,
    spill_loads)}``."""
    kernels, name = {}, None
    for src, text in reports.items():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                kernels[name] = dict(source=src)
                continue
            if name is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                kernels[name].update(spill_stores=int(m.group(1)),
                                     spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                kernels[name]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                kernels[name]["smem"] = int(m.group(1)) if m else 0
    return kernels


# kernel row -> fragments of the mangled names of the instantiations its
# main path runs (bf16 activations), for the row's -Xptxas -v figures
ROW_SYMBOLS = {
    "paged_attention": ("paged_decode_kernelI13__nv_bfloat16S1_",
                        "paged_decode_combine_kernelI13__nv_bfloat16"),
    "paged_attention_int8": ("paged_decode_kernelI13__nv_bfloat16a",
                             "paged_decode_combine_kernelI13__nv_bfloat16"),
    "page_write": ("page_write_kernel",),
    "page_write_int8": ("page_write_int8_kernelI13__nv_bfloat16",),
    "prefill_read": ("prefill_read_mma_kernel",),
    "prefill_read_int8": ("prefill_read_i8_mma_kernel",),
    "int8_matmul": ("quant_matmul_tc_kernelILb0",),
    "int4_matmul": ("quant_matmul_tc_kernelILb1",),
    "layernorm": ("layernorm_kernelI13__nv_bfloat16S1_",),
    "flash_fwd": ("flash_fwd_mma_kernel",),
    "flash_bwd_dq": ("flash_bwd_dq_mma_kernel",),
    "flash_bwd_dkv": ("flash_bwd_dkv_mma_kernel",),
    "adamw": ("adamw_kernelIf13__nv_bfloat16",),
    "lion": ("lion_kernelIf13__nv_bfloat16",),
}


# fragments of the kernel names that must show 0 spill bytes: the
# tensor-core kernels and the kernels redesigned for bytes in flight
NO_SPILL = ("mma_kernel", "_tc_kernel", "paged_decode", "page_write",
            "layernorm_kernel")


def attach_ptxas(rows, built):
    """Each kernel row's ``ptxas``: registers, static shared memory and
    spill bytes of the instantiations of its main path (ROW_SYMBOLS),
    keyed by the mangled name cut after its template arguments."""
    for name, row in rows.items():
        frags = ROW_SYMBOLS.get(name, ())
        row["ptxas"] = {
            re.sub(r"^_ZN3tos\d+", "", sym).split("EEv")[0]: figures
            for sym, figures in built.items()
            if any(f in sym for f in frags)}


def attach_floor(rows, floor_ms):
    """Each kernel row's ``floor_ms``: the timer's floor of this run
    (:func:`launch_floor_ms`), beside the row's times."""
    for row in rows.values():
        row["floor_ms"] = floor_ms


def main_numbers(shapes, label="prefill"):
    """A row's top-level numbers: those of its ``label`` shape (the other
    shapes stay under ``shapes``)."""
    return dict({key: shapes[label][key] for key in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        main_numbers=label)


# kernel -> the modules of one forward that launch it once each, at a
# decode step and at a prefill dispatch (None: not at that shape); a
# bf16 pool's decode write is plain indexing, not kernel 2
KERNEL_FORWARD = {
    "paged_attention": ("attention", None),
    "paged_attention_int8": ("attention", None),
    "page_write": (None, "attention"),
    "page_write_int8": ("attention", "attention"),
    "prefill_read": (None, "attention"),
    "prefill_read_int8": (None, "attention"),
    "int8_matmul": ("quantized", "quantized"),
    "int4_matmul": ("quantized", "quantized"),
    "layernorm": ("fused_ln", "fused_ln"),
}


def forward_modules(model):
    """The modules of one forward that launch a serving kernel once
    each: attention layers, quantised projections, fused LayerNorms."""
    from tensorflowonspark_tpu_torch.models import transformer as tf

    mods = list(model.modules())
    return dict(
        attention=sum(isinstance(m, tf.Attention) for m in mods),
        quantized=sum(isinstance(m, tf.Dense) and m.quant is not None
                      for m in mods),
        fused_ln=sum(isinstance(m, tf.FusedLayerNorm) for m in mods))


def launch_split(launches, modules, decode_steps, prefill_dispatches):
    """Each kernel's launches in a serving run by shape, computed from the
    run's decode steps and prefill dispatches and the launching modules
    of one forward (no counter on the hot path): ``{kernel: dict(decode,
    prefill, adds_up)}``, ``adds_up`` when the two sum to the wrapper's
    own count."""
    split = {}
    for name, n in launches.items():
        at_decode, at_prefill = KERNEL_FORWARD[name]
        dec = decode_steps * modules[at_decode] if at_decode else 0
        pre = prefill_dispatches * modules[at_prefill] if at_prefill else 0
        split[name] = dict(decode=dec, prefill=pre, adds_up=dec + pre == n)
    return split


def decode_times(pa, q, pools, table, lengths, **sc):
    """Kernel 1 apart: the decode kernel alone (its split partials) and
    the one-launch combine alone, timed like the whole call."""
    parts = pa._split_partials(q, *pools, table, lengths, **sc)
    return dict(
        kernel_ms=time_ms(lambda: pa._split_partials(q, *pools, table,
                                                     lengths, **sc)),
        combine_ms=time_ms(lambda: pa._combine_splits(q, *parts)))


def shuffled_table(torch, gen, B, max_pages, n_pages, dev):
    perm = torch.randperm(n_pages - 1, generator=gen).to(torch.int32)
    return perm[:B * max_pages].reshape(B, max_pages).to(dev)


def page_write_case(torch, pp, k, v, pk, pv, table, starts, **shape):
    """Kernel 2 over a float pool at one shape: the pools equal the plain
    version's off the sink (the last page; raises otherwise), then the
    kernel, its plain version and ``index_copy_`` into the flat pools
    timed."""
    dev = k.device
    B, S, n_kv, Dh = k.shape
    NP, page = pk.shape[:2]
    pk2, pv2 = pk.clone(), pv.clone()
    pp._write_pages(k, v, pk, pv, table, starts)
    pp.write_pages_plain(k, v, pk2, pv2, table, starts)
    torch.cuda.synchronize()
    nonsink = torch.arange(NP, device=dev) != NP - 1
    if not (torch.equal(pk[nonsink], pk2[nonsink])
            and torch.equal(pv[nonsink], pv2[nonsink])):
        raise AssertionError(f"page write kernel: pools differ off the "
                             f"sink at S {S}")
    flat_k = pk2.view(NP * page, n_kv * Dh)
    flat_v = pv2.view(NP * page, n_kv * Dh)
    pos = starts.long()[:, None] + torch.arange(S, device=dev)
    dest = (torch.gather(table.long(), 1, pos // page) * page
            + pos % page).reshape(-1)
    k2d, v2d = k.reshape(B * S, -1), v.reshape(B * S, -1)

    def library_write():
        flat_k.index_copy_(0, dest, k2d)
        flat_v.index_copy_(0, dest, v2d)

    b_ms, b_by = bound(2 * 2 * k.numel() * k.element_size(), 0)
    return dict(
        B=B, S=S, n_kv=n_kv, Dh=Dh, page=page, **shape,
        ms=time_ms(lambda: pp._write_pages(k, v, pk, pv, table, starts)),
        plain_ms=time_ms(lambda: pp.write_pages_plain(
            k, v, pk2, pv2, table, starts)),
        library_ms=time_ms(library_write), bound_ms=b_ms, bound_by=b_by)


def page_write_int8_case(torch, pp, k, v, pools, scales, table, starts,
                         **shape):
    """Kernel 2 over an int8 pool at one shape: payload, scales and the
    dequantised chunk bitwise equal to the plain version's on the card
    and on the CPU, off the sink (the last page; raises otherwise), then
    the kernel and its plain version timed.  Returns ``((ck, cv),
    figures)``."""
    dev = k.device
    B, S, n_kv, Dh = k.shape
    NP, page = pools[0].shape[:2]
    plain = [t.clone() for t in pools + scales]
    host = [t.cpu() for t in pools + scales]
    ck, cv = pp._write_pages_int8(k, v, *pools, *scales, table, starts)
    pck, pcv = pp.write_pages_plain(k, v, plain[0], plain[1], table, starts,
                                    plain[2], plain[3])
    hck, hcv = pp.write_pages_plain(k.cpu(), v.cpu(), host[0], host[1],
                                    table.cpu(), starts.cpu(), host[2],
                                    host[3])
    torch.cuda.synchronize()
    nonsink = torch.arange(NP, device=dev) != NP - 1
    same_plain = all(torch.equal(a[nonsink], b[nonsink])
                     for a, b in zip(pools + scales, plain))
    same_cpu = all(torch.equal(a[nonsink].cpu(), b[nonsink.cpu()])
                   for a, b in zip(pools + scales, host))
    same_chunk = (torch.equal(ck, pck) and torch.equal(cv, pcv)
                  and torch.equal(ck.cpu(), hck) and torch.equal(cv.cpu(),
                                                                 hcv))
    if not (same_plain and same_cpu and same_chunk):
        raise AssertionError(
            f"int8 page write at S {S}: bytes differ (plain {same_plain}, "
            f"cpu {same_cpu}, dequantised chunk {same_chunk})")
    elems = k.numel()
    # k, v read and the dequantised k, v written in the activation dtype,
    # the int8 payload and the f32 scales stored
    b_ms, b_by = bound(2 * elems * k.element_size() * 2 + 2 * elems
                       + 2 * B * S * n_kv * 4, 0)
    return (ck, cv), dict(
        B=B, S=S, n_kv=n_kv, Dh=Dh, page=page, **shape,
        bitwise_equal_plain=same_plain, bitwise_equal_cpu=same_cpu,
        ms=time_ms(lambda: pp._write_pages_int8(k, v, *pools, *scales,
                                                table, starts)),
        plain_ms=time_ms(lambda: pp.write_pages_plain(
            k, v, plain[0], plain[1], table, starts, plain[2], plain[3])),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def decode_write_inputs(torch, dev, kv_dtype=None):
    """A decode step's one-token k / v at FLAGSHIP_DECODE (16 rows at
    position 2000, bf16) and a pool to write them into: a bf16 one, or
    with ``kv_dtype="int8"`` an int8 one and its scales."""
    from tensorflowonspark_tpu_torch.benchmarks import (FLAGSHIP_DECODE,
                                                        FLAGSHIP_LM_V2)

    n_kv = FLAGSHIP_LM_V2["n_kv_heads"]
    Dh = FLAGSHIP_LM_V2["d_model"] // FLAGSHIP_LM_V2["n_heads"]
    d = FLAGSHIP_DECODE
    B, page, fill = d["n_slots"], d["page_size"], d["fill"]
    max_pages = d["max_seq"] // page
    NP = B * max_pages + 1
    gen = torch.Generator().manual_seed(SEED + 7)
    k, v = (torch.randn((B, 1, n_kv, Dh), generator=gen).to(
        dev, torch.bfloat16) for _ in range(2))
    if kv_dtype == "int8":
        pools = int8_pool(torch, gen, NP, page, n_kv, Dh, dev)
    else:
        pools = [torch.randn((NP, page, n_kv, Dh), generator=gen).to(
            dev, torch.bfloat16) for _ in range(2)]
    table = shuffled_table(torch, gen, B, max_pages, NP, dev)
    starts = torch.full((B,), fill, dtype=torch.int32, device=dev)
    return k, v, pools, table, starts


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
        **decode_times(pa, q, (pk, pv), table, lengths),
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
    q = torch.randn((B, S, H, Dh), generator=gen).to(dev, bf16)
    k = torch.randn((B, S, n_kv, Dh), generator=gen).to(dev, bf16)
    v = torch.randn((B, S, n_kv, Dh), generator=gen).to(dev, bf16)
    pk = torch.randn((NP, page, n_kv, Dh), generator=gen).to(dev, bf16)
    pv = torch.randn((NP, page, n_kv, Dh), generator=gen).to(dev, bf16)
    table = shuffled_table(torch, gen, B, max_pages, NP, dev)
    starts = torch.full((B,), fill, dtype=torch.int32, device=dev)
    shapes = dict(prefill=page_write_case(
        torch, pp, k, v, pk, pv, table, starts, start=fill,
        dtype="bfloat16"))
    dk, dv, (dpk, dpv), dtable, dstarts = decode_write_inputs(torch, dev)
    shapes["decode"] = page_write_case(
        torch, pp, dk, dv, dpk, dpv, dtable, dstarts,
        start=FLAGSHIP_DECODE["fill"], dtype="bfloat16",
        note="not on the serving path: a bf16 pool's decode write is "
             "plain indexing")
    del dk, dv, dpk, dpv
    rows["page_write"] = dict(
        name="page_write", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/paged_prefill.cu",
        replaces="tensorflowonspark_tpu/ops/paged_prefill.py:100",
        max_abs_err=0.0, tol=0.0, **main_numbers(shapes),
        library_note="index_copy_ x2 into the flat pools", shapes=shapes)
    chunk_bytes = 2 * k.numel() * 2

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
    flops = 4 * visible * Dh
    b_ms, b_by = bound(2 * q.numel() * 2 + chunk_bytes
                       + 2 * B * fill * n_kv * Dh * 2, flops)
    ms = time_ms(lambda: pp._read_attention(q, k, v, pk, pv, table, starts))
    rows["prefill_read"] = dict(
        name="prefill_read", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/paged_prefill.cu",
        replaces="tensorflowonspark_tpu/ops/paged_prefill.py:235",
        max_abs_err=err, tol=TOL, ms=ms,
        **tensor_core_check("prefill_read", flops, ms, b_ms),
        plain_ms=time_ms(lambda: pp.read_attention_plain(
            q, k, v, pk, pv, table, starts), reps=20),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
        shapes=dict(B=B, S=S, H=H, n_kv=n_kv, Dh=Dh, page=page, start=fill,
                    dtype="bfloat16"))
    return rows


def int8_pool(torch, gen, NP, page, n_kv, Dh, dev):
    """An int8 kv pool (payload in [-127, 127]) and its f32 scales, the
    magnitudes of the quantised bf16 activations."""
    pools = [torch.randint(-127, 128, (NP, page, n_kv, Dh), generator=gen,
                           dtype=torch.int8).to(dev) for _ in range(2)]
    scales = [(torch.rand((NP, page, n_kv), generator=gen) * 0.03
               + 0.01).to(dev) for _ in range(2)]
    return pools, scales


def phase_int8_kernels(torch, F, dev):
    """The int8 kv branch of kernels 1-3 against their plain versions at
    the flagship shapes (bf16 activations), timed like phase 3."""
    from tensorflowonspark_tpu_torch.benchmarks import (
        FLAGSHIP_DECODE, FLAGSHIP_LM_V2, FLAGSHIP_PREFILL_KERNEL)
    from tensorflowonspark_tpu_torch.ops import paged_attention as pa
    from tensorflowonspark_tpu_torch.ops import paged_prefill as pp

    H, n_kv = FLAGSHIP_LM_V2["n_heads"], FLAGSHIP_LM_V2["n_kv_heads"]
    Dh = FLAGSHIP_LM_V2["d_model"] // H
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 5)
    rows = {}

    # --- kernel 1, int8 pool, at FLAGSHIP_DECODE ---------------------------
    d = FLAGSHIP_DECODE
    B, page, fill = d["n_slots"], d["page_size"], d["fill"]
    max_pages = d["max_seq"] // page
    NP = B * max_pages + 1
    q = torch.randn((B, 1, H, Dh), generator=gen).to(dev, bf16)
    pools, scales = int8_pool(torch, gen, NP, page, n_kv, Dh, dev)
    sc = dict(key_scales=scales[0], value_scales=scales[1])
    table = shuffled_table(torch, gen, B, max_pages, NP, dev)
    lengths = torch.full((B,), fill + 1, dtype=torch.int32, device=dev)
    out = pa.paged_attention(q, *pools, table, lengths, **sc)
    ref = pa.paged_attention_plain(q, *pools, table, lengths, **sc)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), atol=TOL, rtol=TOL):
        raise AssertionError(f"int8 paged decode kernel disagrees: {err}")
    n = fill + 1
    tl = table.long()
    kd, vd = (pa.dequantize_pages(p[tl], s[tl]).to(bf16)
              .reshape(B, -1, n_kv, Dh)[:, :n].transpose(1, 2).contiguous()
              for p, s in zip(pools, scales))
    qd = q.transpose(1, 2).contiguous()
    b_ms, b_by = bound(q.numel() * 2 * 2 + 2 * B * n * n_kv * (Dh + 4),
                       4 * B * H * n * Dh)
    rows["paged_attention_int8"] = dict(
        name="paged_attention_int8", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
        replaces="tensorflowonspark_tpu/ops/paged_attention.py:85",
        max_abs_err=err, tol=TOL,
        ms=time_ms(lambda: pa.paged_attention(q, *pools, table, lengths,
                                              **sc)),
        **decode_times(pa, q, pools, table, lengths, **sc),
        plain_ms=time_ms(lambda: pa.paged_attention_plain(
            q, *pools, table, lengths, **sc), reps=10),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, enable_gqa=True)),
        library_note="scaled_dot_product_attention on the dequantised bf16 "
                     "dense view",
        bound_ms=b_ms, bound_by=b_by,
        shapes=dict(B=B, S=1, H=H, n_kv=n_kv, Dh=Dh, page=page,
                    max_pages=max_pages, length=n, dtype="bfloat16",
                    kv="int8"))
    del pools, scales, kd, vd, sc

    # --- kernels 2 and 3, int8 pool, at FLAGSHIP_PREFILL_KERNEL ------------
    d = FLAGSHIP_PREFILL_KERNEL
    B, page, fill, S = d["n_slots"], d["page_size"], d["fill"], d["chunk"]
    max_pages = d["max_seq"] // page
    NP = B * max_pages + 1
    q = torch.randn((B, S, H, Dh), generator=gen).to(dev, bf16)
    k = torch.randn((B, S, n_kv, Dh), generator=gen).to(dev, bf16)
    v = torch.randn((B, S, n_kv, Dh), generator=gen).to(dev, bf16)
    pools, scales = int8_pool(torch, gen, NP, page, n_kv, Dh, dev)
    table = shuffled_table(torch, gen, B, max_pages, NP, dev)
    starts = torch.full((B,), fill, dtype=torch.int32, device=dev)
    (ck, cv), pre = page_write_int8_case(torch, pp, k, v, pools, scales,
                                         table, starts, start=fill,
                                         dtype="bfloat16", kv="int8")
    dk, dv, (dpools, dscales), dtable, dstarts = decode_write_inputs(
        torch, dev, "int8")
    _, dec = page_write_int8_case(torch, pp, dk, dv, dpools, dscales,
                                  dtable, dstarts,
                                  start=FLAGSHIP_DECODE["fill"],
                                  dtype="bfloat16", kv="int8")
    del dk, dv, dpools, dscales
    shapes = dict(prefill=pre, decode=dec)
    rows["page_write_int8"] = dict(
        name="page_write_int8", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/paged_prefill.cu",
        replaces="tensorflowonspark_tpu/ops/paged_prefill.py:100",
        max_abs_err=0.0, tol=0.0,
        bitwise_equal_plain=pre["bitwise_equal_plain"]
        and dec["bitwise_equal_plain"],
        bitwise_equal_cpu=pre["bitwise_equal_cpu"]
        and dec["bitwise_equal_cpu"], **main_numbers(shapes),
        library_note="no single library call quantises and scatters",
        shapes=shapes)
    elems = k.numel()

    sc = dict(key_scales=scales[0], value_scales=scales[1])
    out = pp._read_attention(q, ck, cv, *pools, table, starts, **sc)
    ref = pp.read_attention_plain(q, ck, cv, *pools, table, starts, **sc)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), atol=TOL, rtol=TOL):
        raise AssertionError(f"int8 prefill read kernel disagrees: {err}")
    tl = table.long()
    ctx = [pa.dequantize_pages(p[tl], s[tl]).to(bf16)
           .reshape(B, -1, n_kv, Dh)[:, :fill] for p, s in zip(pools, scales)]
    kd = torch.cat([ctx[0], ck], 1).transpose(1, 2).contiguous()
    vd = torch.cat([ctx[1], cv], 1).transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()
    keys = torch.arange(fill + S, device=dev)
    mask = keys[None, :] <= fill + torch.arange(S, device=dev)[:, None]
    visible = B * H * sum(fill + s + 1 for s in range(S))
    flops = 4 * visible * Dh
    b_ms, b_by = bound(2 * q.numel() * 2 + 2 * elems * 2
                       + 2 * B * fill * n_kv * (Dh + 4), flops)
    ms = time_ms(lambda: pp._read_attention(q, ck, cv, *pools, table, starts,
                                            **sc))
    rows["prefill_read_int8"] = dict(
        name="prefill_read_int8", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/paged_prefill.cu",
        replaces="tensorflowonspark_tpu/ops/paged_prefill.py:235",
        max_abs_err=err, tol=TOL, ms=ms,
        **tensor_core_check("prefill_read_int8", flops, ms, b_ms),
        plain_ms=time_ms(lambda: pp.read_attention_plain(
            q, ck, cv, *pools, table, starts, **sc), reps=10),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True)),
        library_note="scaled_dot_product_attention on the dequantised bf16 "
                     "dense view, masked",
        bound_ms=b_ms, bound_by=b_by,
        shapes=dict(B=B, S=S, H=H, n_kv=n_kv, Dh=Dh, page=page, start=fill,
                    dtype="bfloat16", kv="int8"))
    return rows


def phase_layernorm_kernel(torch, F, dev):
    """Kernel 11 against its plain version and F.layer_norm at a prefill
    dispatch (4 rows x 256 tokens) and a decode step (8 slots) of the
    flagship width, bf16 activations and parameters (a serving model
    keeps its norms at the compute width)."""
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_LM
    from tensorflowonspark_tpu_torch.ops import layernorm as ln

    D = FLAGSHIP_LM["d_model"]
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 6)
    w = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev, bf16)
    b = (0.1 * torch.randn(D, generator=gen)).to(dev, bf16)
    shapes, err = {}, 0.0
    for label, N in (("prefill", 1024), ("decode", 8)):
        x = (torch.randn((N, D), generator=gen) * 2 + 0.5).to(dev, bf16)
        out = ln.fused_layernorm(x, w, b)
        ref = ln.layernorm_plain(x, w, b)
        torch.cuda.synchronize()
        e = (out.float() - ref.float()).abs().max().item()
        if not torch.allclose(out.float(), ref.float(), atol=TOL, rtol=TOL):
            raise AssertionError(f"LayerNorm kernel disagrees at N {N}: {e}")
        err = max(err, e)
        # ~8 f32 operations per element on the CUDA cores
        b_ms, b_by = bound(2 * x.numel() * 2 + 2 * D * 2, 8 * x.numel(),
                           PEAK_F32_FLOP_PER_S)
        shapes[label] = dict(
            N=N, D=D, max_abs_err=e,
            ms=time_ms(lambda: ln.fused_layernorm(x, w, b)),
            plain_ms=time_ms(lambda: ln.layernorm_plain(x, w, b)),
            library_ms=time_ms(lambda: F.layer_norm(x, (D,), w, b, 1e-6)),
            bound_ms=b_ms, bound_by=b_by)
    return {"layernorm": dict(
        name="layernorm", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/layernorm.cu",
        replaces="tensorflowonspark_tpu/ops/layernorm.py:19",
        max_abs_err=err, tol=TOL, **main_numbers(shapes),
        library_note="F.layer_norm, bf16", shapes=shapes,
        dtype="bfloat16")}


def compare_serving(torch, dev, cpu, card, label, kv_dtype=None, f32=None):
    """One 300-token paged prefill, then 8 greedy decode steps, of
    ``card`` (on the card) against ``cpu`` (on the CPU), over paged pools
    of ``kv_dtype`` (None: the model's), both taking the
    CPU's greedy token (teacher forcing, so every step compares the same
    context): the largest logit difference within 5e-2 x std(logits) at
    every step, and the greedy tokens agreeing wherever the top-2 margin
    is wider than that tolerance.  With ``f32`` (the f32 model on the
    CPU, when ``cpu`` computes at the card's bf16), each step also
    reports, unchecked, how far the card and ``cpu`` each lie from it.
    Returns the per-step results and the first step whose tokens part
    (None when all agree)."""
    from tensorflowonspark_tpu_torch.models import decode as dm

    max_seq = card.cfg.max_seq_len
    plen, steps, page = 300, 8, 64
    prompt = torch.randint(0, card.cfg.vocab_size, (1, plen),
                           generator=torch.Generator().manual_seed(SEED))
    n_pages = -(-(plen + steps) // page) + 1
    runs = [("card", card, dev), ("cpu", cpu, "cpu")]
    if f32 is not None:
        runs.append(("f32", f32, "cpu"))
    caches = {}
    for name, model, d in runs:
        _, cache = dm.init_paged_slot_cache(model, 1, page, n_pages,
                                            kv_dtype=kv_dtype)
        entries = list(range(n_pages - 1))
        dm.set_row_page_table(
            cache, 0,
            entries + [n_pages - 1] * (max_seq // page - len(entries)))
        caches[name] = cache
    results, parted = [], None
    with torch.no_grad():
        logits = {}
        for name, model, d in runs:
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
            if f32 is not None:
                want = logits["f32"][0].float()
                results[-1].update(
                    card_vs_f32=(got - want).abs().max().item(),
                    cpu_vs_f32=(ref - want).abs().max().item())
            if diff > tol:
                raise AssertionError(f"{label}: step {step} logits differ "
                                     f"by {diff} > {tol}")
            if not agree:
                if margin > tol:
                    raise AssertionError(f"{label}: step {step} greedy "
                                         "tokens differ")
                if parted is None:      # a near tie: within the tolerance
                    parted = dict(step=step, top2_margin=margin, tol=tol)
            if step == steps:
                break
            for name, model, d in runs:
                logits[name] = model(torch.tensor([[tok]], device=d),
                                     caches[name])[:, -1]
    return results, parted


def parity_cpu_model(torch, base=None, **over):
    """``base`` (FLAGSHIP_LM_V2 by default) cut to 2 layers at full
    width, f32 on the CPU, random from the seed."""
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_LM_V2
    from tensorflowonspark_tpu_torch.models.transformer import (
        build_transformer)

    cfg = dict(base or FLAGSHIP_LM_V2, n_layers=2, max_seq_len=4096, **over)
    cpu = build_transformer(**dict(cfg, dtype="float32")).eval()
    cpu.reset_parameters(torch.Generator().manual_seed(SEED))
    return cfg, cpu


def card_copy(torch, dev, cfg, cpu):
    """The CPU model's weights in a bf16 model of ``cfg`` on ``dev``."""
    from tensorflowonspark_tpu_torch.models.transformer import (
        build_transformer)

    with torch.device("meta"):
        card = build_transformer(**cfg)
    card.load_state_dict({k: v.to(dev, torch.bfloat16)
                          for k, v in cpu.state_dict().items()},
                         assign=True)
    return card.eval()


def parity_summary(steps, parted):
    out = dict(steps=steps, first_token_parting=parted,
               tokens_agree=sum(r["token_agrees"] for r in steps),
               positions=len(steps),
               max_abs_diff=max(r["max_abs_diff"] for r in steps),
               tol=min(r["tol"] for r in steps))
    for key in ("card_vs_f32", "cpu_vs_f32"):
        if key in steps[0]:
            out[key] = max(r[key] for r in steps)
    return out


def phase_parity(torch, dev):
    """2-layer full-width flagship: card (bf16, kernels) vs CPU (f32,
    plain versions) on the same weights."""
    cfg, cpu = parity_cpu_model(torch)
    results, _ = compare_serving(torch, dev, cpu,
                                 card_copy(torch, dev, cfg, cpu),
                                 "full-width parity")
    return results


def phase_slice4_parity(torch, dev):
    """Phase 4 over an int8 kv pool (FLAGSHIP_LM_V2) and with the fused
    LayerNorm (FLAGSHIP_LM, fused_ln=True), on the same weights.  The
    checked reference is the CPU at the card's bf16 (plain versions):
    on the CPU alone, bf16 already lies about one phase-4 tolerance from
    f32 for these two models (the int8 round trip of bf16 k/v moves by
    whole quantisation steps where f32 k/v would not; the LayerNorm
    model's bf16 logits spread wider).  Each step also reports the card's
    and the bf16 CPU's distance from the f32 CPU run."""
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_LM

    out = {}
    for label, base, over, kv in (
            ("int8_kv", None, {}, "int8"),
            ("fused_ln", FLAGSHIP_LM, {"fused_ln": True}, None)):
        cfg, cpu = parity_cpu_model(torch, base, **over)
        cpu16 = card_copy(torch, "cpu", cfg, cpu)
        card = card_copy(torch, dev, cfg, cpu)
        steps, parted = compare_serving(torch, dev, cpu16, card,
                                        f"{label} parity", kv_dtype=kv,
                                        f32=cpu)
        out[label] = parity_summary(steps, parted)
        del cpu, cpu16, card
        torch.cuda.empty_cache()
    return out


def phase_quant_parity(torch, dev):
    """Phase 4 with quantised weights: the 2-layer full-width flagship
    quantised once on the CPU from its f32 masters (int8, then int4); the
    card runs those bytes at bf16 through kernels 9 / 10 and 1-3, the CPU
    in f32 through the plain versions."""
    import copy

    from tensorflowonspark_tpu_torch import quantize
    from tensorflowonspark_tpu_torch.models.transformer import (
        Dense, build_transformer)

    cfg, cpu = parity_cpu_model(torch)
    out = {}
    for mode in quantize.MODES:
        qcpu = copy.deepcopy(cpu)
        quantize.quantize_module(qcpu, mode)
        # the card model is built at the flagship's own bf16 width, as
        # phase 4's is: its Dense layers compute in bf16, so kernels 9 /
        # 10 run their bf16 branch on the CPU-quantised bytes
        with torch.device("meta"):
            card = build_transformer(**cfg)
        if card.cfg.dtype != "bfloat16":
            raise AssertionError(f"{mode} parity: card model computes in "
                                 f"{card.cfg.dtype}, not bfloat16")
        qmods = {name: mod for name, mod in qcpu.named_modules()
                 if isinstance(mod, Dense) and mod.quant is not None}
        quantized = set()
        for name, mod in card.named_modules():
            if name in qmods:
                leaf = qmods[name].quantized_leaf()
                if mode == "int8":
                    leaf = {k: v.to(dev) for k, v in leaf.items()}
                else:
                    leaf = quantize.Int4Weight(leaf.q.to(dev),
                                               leaf.scale.to(dev),
                                               leaf.in_dim, leaf.group_size)
                mod.set_quantized(leaf)
                quantized |= {f"{name}.q", f"{name}.scale"}
        # q stays int8 and the scales f32; every other float leaf is bf16
        card.load_state_dict(
            {k: (v.to(dev) if k in quantized else v.to(dev, torch.bfloat16))
             for k, v in qcpu.state_dict().items()}, assign=True)
        card.eval()
        steps, parted = compare_serving(torch, dev, qcpu, card,
                                        f"{mode} parity")
        out[mode] = parity_summary(steps, parted)
        del qcpu, card
        torch.cuda.empty_cache()
    return out


# kernel-name fragments -> the group a training step's device time is
# reported under (first match wins; the rest is "other")
KERNEL_GROUPS = (("tos::quant_matmul", "quant matmul kernels"),
                 ("tos::split_sum", "quant matmul kernels"),
                 ("tos::paged_decode", "paged kernels"),
                 ("tos::page_write", "paged kernels"),
                 ("tos::prefill_read", "paged kernels"),
                 ("tos::layernorm", "layernorm kernel"),
                 ("tos::flash", "flash kernels"),
                 ("tos::adamw", "adamw kernel"),
                 ("tos::lion", "lion kernel"),
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


def make_flagship_export(torch, dev, base=None, name="export", **over):
    """Full-depth ``base`` (FLAGSHIP_LM_V2 by default) with random f32
    master weights from the seed, built on the card and exported
    (``params.pt``) once for the serving phases.  Returns ``(cfg,
    export_dir, n_params)``."""
    from tensorflowonspark_tpu_torch import export
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_LM_V2
    from tensorflowonspark_tpu_torch.models.transformer import (
        build_transformer)

    cfg = dict(base or FLAGSHIP_LM_V2, max_seq_len=4096, **over)
    with torch.device(dev):
        model = build_transformer(**cfg)
    model.reset_parameters(torch.Generator(dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    export_dir = os.path.join(HERE, "build", "chip_smoke", name)
    shutil.rmtree(export_dir, ignore_errors=True)
    export.export_saved_model(export_dir, model.state_dict(),
                              builder_kwargs=cfg)
    del model
    torch.cuda.empty_cache()
    return cfg, export_dir, n_params


def get_json(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def phase_main_path(torch, dev, cfg, export_dir, quantize="none",
                    kv_dtype="auto"):
    """Full-depth flagship served through make_server on 127.0.0.1, with
    bf16 weights or (``quantize``) int8 / int4 projections, over a bf16
    or (``kv_dtype``) int8 kv pool."""
    from tensorflowonspark_tpu_torch import ops, serve

    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    args = serve.build_argparser().parse_args([
        "--export_dir", export_dir, "--device", str(dev),
        "--host", "127.0.0.1", "--port", "0",
        "--generate_kv_page_size", "64", "--generate_kv_pages", "512",
        "--generate_slots", "8", "--generate_prefill_chunk", "256",
        "--max_new_tokens_limit", "64", "--generate_quantize", quantize,
        "--generate_kv_dtype", kv_dtype])
    t0 = time.monotonic()
    server, service = serve.make_server(args)
    gen_service = service.generate_service()   # load the export onto the card
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    memory_allocated = torch.cuda.memory_allocated() - mem_before
    model = gen_service.model
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       list(model.parameters()) + list(model.buffers()))
    modules = forward_modules(model)
    del model, gen_service
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}/v1/models/default"
    url = base + ":generate"
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
        batcher = service.generate_service().batcher
        launches = ops.launch_counts(batcher.kernels)
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel never launched: {launches}")
        stats = batcher.stats()
        free = list(batcher._free_pages)
        owned = [p for pages in batcher._row_pages if pages for p in pages]
        if (len(set(free)) != len(free) or batcher._sink in free
                or sorted(free + owned) != list(range(batcher._total_pages))):
            raise AssertionError("the page pool does not conserve its pages")
        meta = get_json(base)["model"]
        qinfo = meta.get("generate_quantize")
        if (quantize != "none") != (qinfo is not None) or (
                qinfo and qinfo["mode"] != quantize):
            raise AssertionError(f"metadata reports {qinfo} for {quantize}")
        reported = meta["generate_stats"].get("kv_dtype", "auto")
        if reported != kv_dtype:
            raise AssertionError(f"stats report kv_dtype {reported} for "
                                 f"{kv_dtype}")
        del batcher
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    new_tokens = len(prompts) * max_new
    return launches, dict(
        quantize=quantize, kv_dtype=kv_dtype, fused_ln=cfg.get("fused_ln",
                                                               False),
        norm_type=cfg.get("norm_type", "layernorm"), layers=cfg["n_layers"],
        load_s=load_s, resident_weight_bytes=weight_bytes,
        kv_pool_bytes=stats["kv_pool_bytes"],
        # both asserted above: the run fails when either is false
        pool_conserved=True, solo_equals_burst=True,
        memory_allocated_by_load=memory_allocated,
        generate_quantize=qinfo,
        burst_requests=len(prompts), prompt_tokens=sum(lens),
        burst_s=burst_s, burst_new_tokens_per_s=new_tokens / burst_s,
        ttft_mean_ms=1000.0 * stats["ttft_sum_s"] / stats["ttft_count"],
        decode_step_ms=stats["decode_step_ms_mean"],
        decode_steps=stats["decode_steps"],
        prefill_dispatches=stats["prefill_dispatches"],
        requests_served=stats["requests_served"], launches=launches,
        forward_modules=modules,
        # decode steps run every slot one token each (8 rows), prefill
        # dispatches the admitted rows' chunks
        launches_by_shape=launch_split(launches, modules,
                                       stats["decode_steps"],
                                       stats["prefill_dispatches"]),
        solo_profile=profile)


def phase_quant_kernels(torch, F, dev):
    """Kernels 9 and 10 against their plain versions at the flagship
    ``wi`` shape (K 2048 -> N 8192) and at ``wo`` (K 8192 -> N 2048, its
    own chunk plan), timed at a decode step and at a prefill dispatch,
    with the achieved TFLOP/s and the share of the bound beside each
    time."""
    from tensorflowonspark_tpu_torch import quantize
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_QUANT_MATMUL
    from tensorflowonspark_tpu_torch.ops import quant_matmul as qm

    d = FLAGSHIP_QUANT_MATMUL
    K, N, G = d["K"], d["N"], d["group_size"]
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 4)
    w = torch.randn((K, N), generator=gen) * K ** -0.5   # lecun-normal
    # quantising on the card gives the CPU's bytes
    leaves = {"int8": quantize.quantize_int8(w),
              "int4": quantize.int4_pack(w, G)}
    card8 = quantize.quantize_int8(w.to(dev))
    card4 = quantize.int4_pack(w.to(dev), G)
    same = (torch.equal(card8["q"].cpu(), leaves["int8"]["q"])
            and torch.equal(card8["scale"].cpu(), leaves["int8"]["scale"])
            and torch.equal(card4.q.cpu(), leaves["int4"].q)
            and torch.equal(card4.scale.cpu(), leaves["int4"].scale))
    if not same:
        raise AssertionError("quantising on the card changed the bytes")
    # `wo`: the transposed projection, N -> K
    w_wo = (torch.randn((N, K), generator=gen) * N ** -0.5).to(dev)
    on_card = {("wi", "int8"): card8, ("wi", "int4"): card4,
               ("wo", "int8"): quantize.quantize_int8(w_wo),
               ("wo", "int4"): quantize.int4_pack(w_wo, G)}
    del w_wo
    xs = {(kd, m): torch.randn((m, kd), generator=gen).to(dev, bf16)
          for kd in (K, N) for m in (d["decode_m"], d["prefill_m"])}
    rows = {}
    for mode, plain in (("int8", qm.int8_matmul_plain),
                        ("int4", qm.int4_matmul_plain)):
        shapes = {}
        # the `wi` shapes keep their labels; `wo`'s are prefixed
        for proj, kd, nd in (("wi", K, N), ("wo", N, K)):
            leaf = on_card[proj, mode]
            w_bytes = (kd * nd + 4 * nd if mode == "int8"
                       else leaf.q.numel() + 4 * leaf.scale.numel())
            # the library's call: a W16 store, F.linear on the bf16 weight
            w16 = quantize.dequantize_leaf(leaf, bf16).t().contiguous()
            for label, M in (("decode", d["decode_m"]),
                             ("prefill", d["prefill_m"])):
                x = xs[kd, M]
                got = qm.quant_matmul(x, leaf)
                want = plain(x, leaf)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                if err > QMM_TOL * scale:
                    raise AssertionError(
                        f"{mode} matmul kernel disagrees at {proj} M {M}: "
                        f"{err} > {QMM_TOL} x {scale}")
                flops = 2 * M * kd * nd
                b_ms, b_by = bound(w_bytes + 2 * M * kd + 2 * M * nd, flops)
                ms = time_ms(lambda: qm.quant_matmul(x, leaf))
                shapes[label if proj == "wi" else f"wo_{label}"] = dict(
                    M=M, K=kd, N=nd, max_abs_err=err, tol=QMM_TOL * scale,
                    ms=ms, tflops=flops / ms / 1e9, bound_share=b_ms / ms,
                    plain_ms=time_ms(lambda: plain(x, leaf), reps=10),
                    library_ms=time_ms(lambda: F.linear(x, w16)),
                    bound_ms=b_ms, bound_by=b_by,
                    weight_bytes=w_bytes, library_weight_bytes=2 * kd * nd)
            del w16
        dec = shapes["decode"]
        number = "9" if mode == "int8" else "10"
        rows[f"{mode}_matmul"] = dict(
            name=f"{mode}_matmul", route="cuda",
            source="tensorflowonspark_tpu_torch/csrc/quant_matmul.cu",
            replaces=("tensorflowonspark_tpu/ops/quant_matmul.py:81"
                      if mode == "int8" else
                      "tensorflowonspark_tpu/ops/quant_matmul.py:101"),
            kernel=number, max_abs_err=max(v["max_abs_err"]
                                           for v in shapes.values()),
            ms=dec["ms"], plain_ms=dec["plain_ms"],
            library_ms=dec["library_ms"], bound_ms=dec["bound_ms"],
            bound_by=dec["bound_by"], main_numbers="decode",
            library_note="F.linear on the bf16 dequantised weight",
            group_size=G if mode == "int4" else None, shapes=shapes,
            quantized_on_card_equals_cpu=same, dtype="bfloat16",
            bf16_path="tensor cores (mma.sync.m16n8k16)")
    return rows


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

    def row_rel_err(name, got, want):
        # the largest error norm of a row (one key of one kv head) over
        # its reference row's norm; every key is seen by some query
        want = want.float()
        rel = ((got.float() - want).norm(dim=-1)
               / want.norm(dim=-1).clamp_min(1e-30)).max().item()
        if not rel <= GRAD_ROW_RTOL:
            raise AssertionError(f"{name} kernel disagrees by {rel} of a "
                                 f"key's row")
        return rel

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
    flops = 4 * visible * D
    b_ms, b_by = bound(2 * qb + 2 * kvb + rowb, flops)
    ms = time_ms(lambda: fa.flash_fwd(q, k, v, True))
    rows["flash_fwd"] = dict(
        name="flash_fwd", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/flash_attention.cu",
        replaces="tensorflowonspark_tpu/ops/flash_attention.py:56",
        max_abs_err=err, lse_max_abs_err=lse_err, tol=TOL, ms=ms,
        **tensor_core_check("flash_fwd", flops, ms, b_ms),
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

    # --- kernel 5: dq (bf16, tensor cores) -----------------------------------
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, True)
    want = fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, True)
    err = compare("flash dq", dq, want, GRAD_ATOL)
    del dq, want
    flops = 6 * visible * D
    b_ms, b_by = bound(3 * qb + 2 * kvb + 2 * rowb, flops)
    ms = time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, True))
    rows["flash_bwd_dq"] = dict(
        name="flash_bwd_dq", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/flash_attention.cu",
        replaces="tensorflowonspark_tpu/ops/flash_attention.py:116",
        max_abs_err=err, tol=GRAD_ATOL, ms=ms,
        **tensor_core_check("flash_bwd_dq", flops, ms, b_ms),
        plain_ms=time_ms(lambda: fa.flash_bwd_dq_plain(
            q, k, v, do, ref_lse, delta, True), reps=5),
        library_ms=lib_bwd_ms, library_covers="dq+dk+dv",
        bound_ms=b_ms, bound_by=b_by, shapes=shapes)

    # --- kernel 6: narrow dk/dv (bf16, tensor cores) -----------------------
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, True)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta,
                                              True)
    errs = dict(dk=compare("flash dk", dk, want_dk, GRAD_ATOL),
                dv=compare("flash dv", dv, want_dv, GRAD_ATOL))
    row_errs = dict(dk=row_rel_err("flash dk", dk, want_dk),
                    dv=row_rel_err("flash dv", dv, want_dv))
    del dk, dv, want_dk, want_dv
    flops = 8 * visible * D
    b_ms, b_by = bound(2 * qb + 4 * kvb + 2 * rowb, flops)
    ms = time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, True))
    rows["flash_bwd_dkv"] = dict(
        name="flash_bwd_dkv", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/flash_attention.cu",
        replaces="tensorflowonspark_tpu/ops/flash_attention.py:157",
        max_abs_err=max(errs.values()), max_abs_errs=errs,
        row_rel_errs=row_errs, tol=GRAD_ATOL, row_rtol=GRAD_ROW_RTOL, ms=ms,
        **tensor_core_check("flash_bwd_dkv", flops, ms, b_ms),
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


def flagship_tree(torch, dev, seed):
    """Random f32 parameters and gradients of the flagship's shapes, by
    name, on the card."""
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_LM_V2
    from tensorflowonspark_tpu_torch.models.transformer import (
        build_transformer)

    with torch.device("meta"):
        tree = build_transformer(**FLAGSHIP_LM_V2)
    shapes_of = {n: p.shape for n, p in tree.named_parameters()}
    cgen = torch.Generator(dev).manual_seed(seed)
    params = {n: torch.randn(s, device=dev, generator=cgen)
              for n, s in shapes_of.items()}
    grads = {n: torch.randn(s, device=dev, generator=cgen)
             for n, s in shapes_of.items()}
    return params, grads


def phase_lion_kernel(torch, dev):
    """Kernel 8 over the whole flagship tree against its plain version,
    bitwise, timed."""
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_MU_DTYPE
    from tensorflowonspark_tpu_torch.ops import fused_optim as fo
    from tensorflowonspark_tpu_torch.optim import make_optimizer

    params, grads = flagship_tree(torch, dev, SEED + 4)
    opt, _ = make_optimizer("lion_fused", learning_rate=3e-4,
                            mu_dtype=FLAGSHIP_MU_DTYPE)
    state = opt.init(params)
    for n in params:            # a momentum of a run in progress
        state.mu[n].copy_(0.1 * grads[n])
    n_params = sum(p.numel() for p in params.values())
    scal = fo._scalars(lambda c: torch.full_like(c, 3e-4, dtype=torch.float32),
                       state.count, None, 0.9, 0.99, grads)
    kw = dict(b1=0.9, b2=0.99, wd=0.0, write_param=True)
    err = 0.0
    for n, g in grads.items():
        want = fo.lion_plain(g, params[n], state.mu[n], scal, **kw)
        fo._lion(g, params[n], state.mu[n], scal, params[n], **kw)
        torch.cuda.synchronize()
        if not (torch.equal(params[n], want[0])
                and torch.equal(state.mu[n], want[1])):
            raise AssertionError(f"Lion kernel is not bitwise equal to its "
                                 f"plain version on {n}")
        err = max(err, (params[n] - want[0]).abs().max().item())
        del want

    def plain_tree():
        for n, g in grads.items():
            fo.lion_plain(g, params[n], state.mu[n], scal, **kw)

    ms = time_ms(lambda: opt.apply(grads, state, params), reps=10)
    plain_ms = time_ms(plain_tree, reps=3)
    # g and p f32 read, bf16 mu read; p f32 and mu bf16 written
    b_ms, b_by = bound(n_params * (2 * 4 + 2) + n_params * (4 + 2), 0)
    n_leaves = len(params)
    del state, params, grads
    torch.cuda.empty_cache()
    return {"lion": dict(
        name="lion", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/fused_optim.cu",
        replaces="tensorflowonspark_tpu/ops/fused_optim.py:131",
        max_abs_err=err, tol=0.0, bitwise=True, ms=ms, plain_ms=plain_ms,
        library_ms=None, library_note="no PyTorch call computes Lion",
        bound_ms=b_ms, bound_by=b_by,
        bound_bytes=n_params * 16,
        shapes=dict(params=n_params, leaves=n_leaves, p="float32",
                    g="float32", mu=FLAGSHIP_MU_DTYPE))}


def phase_lse_path(torch, dev):
    """flash_attention_with_lse at phase 6's layer and at head_dim 64:
    out and lse, and the gradients under a random lse cotangent, against
    the plain versions."""
    from tensorflowonspark_tpu_torch import ops
    from tensorflowonspark_tpu_torch.benchmarks import (
        FLAGSHIP_BATCH, FLAGSHIP_LM_V2)
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    B, S = FLAGSHIP_BATCH, FLAGSHIP_LM_V2["max_seq_len"]
    H, n_kv = FLAGSHIP_LM_V2["n_heads"], FLAGSHIP_LM_V2["n_kv_heads"]
    bf16 = torch.bfloat16
    out_rows = []
    for D in (FLAGSHIP_LM_V2["d_model"] // H, 64):
        gen = torch.Generator().manual_seed(SEED + 5 + D)
        q, k, v = (torch.randn((B, S, h, D), generator=gen).to(dev, bf16)
                   .requires_grad_(True) for h in (H, n_kv, n_kv))
        do = torch.randn((B, S, H, D), generator=gen).to(dev, bf16)
        g_lse = torch.randn((B, H, S), generator=gen).to(dev)
        before = ops.launch_counts(ops.TRAINING_KERNELS)
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
        dq, dk, dv = torch.autograd.grad((out, lse), (q, k, v),
                                         (do, g_lse))
        torch.cuda.synchronize()
        after = ops.launch_counts(ops.TRAINING_KERNELS)
        q, k, v = q.detach(), k.detach(), v.detach()
        ref, ref_lse = fa.flash_fwd_plain(q, k, v, True)
        delta = (torch.einsum("bshd,bshd->bhs", do.float(), ref.float())
                 - g_lse)
        want = [fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, True),
                *fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta, True)]
        errs = {}
        for name, got, ref_t, atol in (
                ("out", out, ref, TOL), ("lse", lse, ref_lse, TOL),
                ("dq", dq, want[0], GRAD_ATOL), ("dk", dk, want[1],
                                                 GRAD_ATOL),
                ("dv", dv, want[2], GRAD_ATOL)):
            errs[name] = (got.float() - ref_t.float()).abs().max().item()
            if not torch.allclose(got.float(), ref_t.float(), atol=atol,
                                  rtol=TOL):
                raise AssertionError(f"lse path D {D}: {name} disagrees "
                                     f"({errs[name]})")
        launched = {n: after[n] - before[n] for n in after}
        if any(launched[n] != 1 for n in ("flash_fwd", "flash_bwd_dq",
                                          "flash_bwd_dkv")):
            raise AssertionError(f"lse path D {D}: launches {launched}")
        out_rows.append(dict(D=D, max_abs_err=errs, launches=launched))
        del q, k, v, do, g_lse, out, lse, dq, dk, dv, ref, ref_lse, want
        torch.cuda.empty_cache()
    return dict(B=B, S=S, H=H, n_kv=n_kv, dtype="bfloat16", causal=True,
                tol=dict(out_lse=TOL, grads=GRAD_ATOL, rtol=TOL),
                cases=out_rows)


def flagship_step(name, batch=None, cfg="v2", dev=None):
    """``make_flagship_step``'s step with optimizer ``name`` (None:
    adamw_fused); ``adamw8bit`` and ``adafactor``, which refuse the
    bf16 mu of make_flagship_step, are built with ``make_optimizer(name,
    learning_rate=3e-4)`` and ``make_train_step`` on the same model."""
    from tensorflowonspark_tpu_torch.benchmarks import make_flagship_step
    from tensorflowonspark_tpu_torch.models.transformer import lm_loss
    from tensorflowonspark_tpu_torch.optim import make_optimizer
    from tensorflowonspark_tpu_torch.parallel import train as train_mod

    if name not in ("adamw8bit", "adafactor"):
        return make_flagship_step(batch, None, cfg, optimizer=name,
                                  device=dev)
    _, state, tokens, n_params = make_flagship_step(batch, None, cfg,
                                                    optimizer="sgd0",
                                                    device=dev)
    opt, _ = make_optimizer(name, learning_rate=3e-4)
    step = train_mod.make_train_step(
        lambda m, b, r: lm_loss(m(b[:, :-1]), b[:, 1:]), opt, donate=True)
    return (step, train_mod.create_train_state(state.params, opt), tokens,
            n_params)


def phase_opt_parity(torch, dev, name, steps=1):
    """Phase 7 (``name`` None: adamw_fused) and 7b: ``steps`` steps of the
    2-layer full-width flagship with optimizer ``name`` on the card (bf16
    compute over f32 masters, kernels) and on the CPU (f32, plain
    versions) from the same weights.  bf16 activations keep ~3
    significant digits: each step's loss within 1%, its gradient norm
    within 5%.  Each step moves each element by about its optimizer's
    step s: AdamW and adamw8bit g / |g| x lr on the first step and about
    lr after it, lion_fused sign(g) x lr, adafactor g over its rms
    estimate x lr x rms(p) (+-1 where the second moment is not factored,
    as for 1-D leaves).  Updates agree where the two agree on the
    gradient's sign; only elements with a gradient near 0 may turn.  So
    an element agrees where the two moves lie within s / 2, 95% of all
    elements and 90% of each leaf's must agree, and (all but adafactor)
    none differs by more than twice the most the steps can move it: s a
    step, but 2 s for adamw8bit's later steps, whose int8 first moment
    may round up to twice its value (about 1.5 s at the most)."""
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_LM_V2

    label = name or "adamw_fused"
    cfg = dict(FLAGSHIP_LM_V2, n_layers=2, max_seq_len=256)
    cpu_step, cpu_state, tokens, _ = flagship_step(
        name, 2, dict(cfg, dtype="float32", attention_impl="flash"), "cpu")
    step, state, card_tokens, _ = flagship_step(name, 2, cfg, dev)
    state.params.load_state_dict(cpu_state.params.state_dict())
    before = {n: t.detach().clone()
              for n, t in cpu_state.params.state_dict().items()}
    lr = 3e-4
    losses, norms = [], []
    for _ in range(steps):
        cpu_state, want = cpu_step(cpu_state, tokens, None)
        state, got = step(state, card_tokens, None)
        loss = (got["loss"].item(), want["loss"].item())
        norm = (got["grad_norm"].item(), want["grad_norm"].item())
        if abs(loss[0] - loss[1]) > 1e-2 * abs(loss[1]):
            raise AssertionError(f"{label} parity: loss card/cpu {loss}")
        if abs(norm[0] - norm[1]) > 5e-2 * abs(norm[1]):
            raise AssertionError(f"{label} parity: grad norm card/cpu "
                                 f"{norm}")
        losses.append(loss)
        norms.append(norm)
    cpu_params = cpu_state.params.state_dict()
    agree, total, worst = 0, 0, (1.0, None)
    for n, t in state.params.state_dict().items():
        s_n = lr
        if name == "adafactor":
            s_n = lr * max(before[n].pow(2).mean().sqrt().item(), 1e-3)
        d_card = t.detach().cpu() - before[n]
        d_cpu = cpu_params[n] - before[n]
        diff = (d_card - d_cpu).abs()
        reach = s_n * (1 + (2 if name == "adamw8bit" else 1) * (steps - 1))
        if name != "adafactor" and diff.max().item() > 2 * reach + 1e-6:
            raise AssertionError(f"{label} parity: {n} moved more than "
                                 f"2 x {reach}")
        same = (diff <= s_n / 2).sum().item()
        agree += same
        total += t.numel()
        if same / t.numel() < worst[0]:
            worst = (same / t.numel(), n)
    if agree / total < 0.95 or worst[0] < 0.9:
        raise AssertionError(f"{label} parity: updates agree on "
                             f"{agree / total:.4f} (worst {worst})")
    out = dict(optimizer=label, layers=cfg["n_layers"], batch=2,
               seq=cfg["max_seq_len"], steps=steps,
               loss_card=[x[0] for x in losses],
               loss_cpu=[x[1] for x in losses],
               grad_norm_card=[x[0] for x in norms],
               grad_norm_cpu=[x[1] for x in norms],
               update_agreement=agree / total,
               worst_leaf_agreement=worst[0], worst_leaf=worst[1],
               tol=dict(loss_rel=1e-2, grad_norm_rel=5e-2,
                        update_agreement=0.95, leaf_agreement=0.9,
                        agree_within="step / 2"))
    if name == "adamw8bit":
        out["state_check"] = check_8bit_state(torch, state)
    return out


def _to_cpu(tree):
    """A copy of a state tree (tensors, dicts, tuples, NamedTuples) on
    the CPU."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_to_cpu(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree.cpu() if hasattr(tree, "cpu") else tree


def check_8bit_state(torch, state, seed=7):
    """One more ``adamw8bit`` update from ``state`` (the card's int8
    moments after phase 7b's steps) and one random gradient, on the card
    and on the CPU from the same inputs: dequantise, update, requantise.
    The int8 payloads and f32 scales must be equal bit for bit; the
    updates within rtol 1e-6 (the bias corrections come from
    ``torch.pow``, which the card's math library may round an ulp away
    from the CPU's)."""
    from tensorflowonspark_tpu_torch.optim import make_optimizer

    opt, _ = make_optimizer("adamw8bit", learning_rate=3e-4)
    params = {n: p.detach() for n, p in state.params.named_parameters()}
    gen = torch.Generator().manual_seed(seed)
    grads = {n: 1e-2 * torch.randn(p.shape, generator=gen)
             for n, p in params.items()}
    with torch.no_grad():
        got, got_state = opt.update(
            {n: g.to(params[n].device) for n, g in grads.items()},
            state.opt_state, params)
        want, want_state = opt.update(
            grads, _to_cpu(state.opt_state),
            {n: p.cpu() for n, p in params.items()})
    got_8bit, want_8bit = got_state[0], want_state[0]
    for n in params:
        for part in ("mu", "nu_sqrt"):
            a, b = getattr(got_8bit, part)[n], getattr(want_8bit, part)[n]
            if not (torch.equal(a.q.cpu(), b.q)
                    and torch.equal(a.scale.cpu(), b.scale)):
                raise AssertionError(f"adamw8bit state: {n} {part} card "
                                     f"and cpu bits differ")
    rel = max(((got[n].cpu() - want[n]).abs()
               / want[n].abs().clamp_min(1e-30)).max().item()
              for n in params)
    if rel > 1e-6:
        raise AssertionError(f"adamw8bit state: update rel err {rel}")
    return dict(count=int(want_8bit.count), leaves=len(params),
                elements=sum(p.numel() for p in params.values()),
                payloads_and_scales="bitwise", update_max_rel_err=rel,
                tol=dict(update_rtol=1e-6))


def phase_train_main(torch, dev, optimizer=None, windows=2, window=5,
                     profile=True, must_fall=True):
    """Full-depth flagship train step on the card with ``optimizer``
    (None: adamw_fused), timed: a warm-up step, the best of ``windows``
    windows of ``window`` steps, then (``profile``) one step under
    torch.profiler."""
    from tensorflowonspark_tpu_torch import ops
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_LM_V2

    t0 = time.monotonic()
    step, state, tokens, n_params = flagship_step(optimizer, dev=dev)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    B, S = tokens.shape[0], tokens.shape[1] - 1
    layers = FLAGSHIP_LM_V2["n_layers"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses = []
    state, m = step(state, tokens, None)             # warm-up
    losses.append(m["loss"])
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t = time.monotonic()
        for _ in range(window):
            state, m = step(state, tokens, None)
            losses.append(m["loss"])
        m["loss"].item()              # the readback closes the window
        times.append((time.monotonic() - t) * 1000.0 / window)
    extra = {}
    if profile:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.monotonic()
            state, m = step(state, tokens, None)
            losses.append(m["loss"])
            m["loss"].item()
            profiled_ms = (time.monotonic() - t) * 1000.0
        extra["step_profile"] = profile_summary(prof, profiled_ms, top=12)
    launches = ops.launch_counts(ops.TRAINING_KERNELS)
    steps = len(losses)
    losses = [x.item() for x in losses]
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"training loss is not finite: {losses}")
    if must_fall and not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] != layers * steps:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{steps} steps of {layers} layers")
    kernel = {None: "adamw", "lion_fused": "lion"}.get(optimizer)
    n_leaves = len(list(state.params.parameters()))
    if kernel and launches[kernel] != n_leaves * steps:
        raise AssertionError(f"{kernel}: {launches[kernel]} launches in "
                             f"{steps} steps of {n_leaves} leaves")
    step_ms = min(times)
    return launches, dict(
        optimizer=optimizer or "adamw_fused", params=n_params,
        layers=layers, batch=B, seq=S, setup_s=setup_s, steps=steps,
        window_step_ms=times, step_ms=step_ms,
        tokens_per_s=B * S / (step_ms / 1000.0),
        mfu=6.0 * n_params * B * S / (step_ms / 1000.0)
        / PEAK_BF16_FLOP_PER_S,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        losses=losses, loss_fell=losses[-1] < losses[0], launches=launches,
        **extra)


# phase 10: the cluster runtime feeding the flagship train step
CLUSTER_STEPS = 11              # a warm-up step and 2 windows of 5
CLUSTER_WINDOWS, CLUSTER_WINDOW = 2, 5
CLUSTER_SCORE_ROWS = 32


def cluster_rows(seed, n, vocab, seq):
    """``n`` token rows of ``seq + 1`` int32 from a seeded RandomState:
    the records the cluster phases feed."""
    import numpy as np

    return np.random.RandomState(seed).randint(
        0, vocab, (n, seq + 1)).astype(np.int32)


def _card_flags(torch):
    # the parent's settings (main()), so both sides run the same kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fed_train_fn(args, ctx):
    """Phase 10's training map_fun, run by the cluster's node process (a
    fork of a spawn-started executor, so the first CUDA call here
    initialises CUDA for this process): the flagship step of
    ``make_flagship_step()`` over ``args["steps"]`` batches taken from
    the node's DataFeed through the port's prefetch — a warm-up step,
    then ``args["windows"]`` windows of ``args["window"]`` steps, each
    closed by a loss readback.  Writes what it saw and timed to
    ``fed_train.json`` in the executor's working dir."""
    import itertools

    t0 = time.time()
    # the executor (and so this fork of it) must not have loaded torch:
    # a fork of a process whose CPU thread pool ran hangs or crawls
    torch_preloaded = "torch" in sys.modules
    import torch
    from tensorflowonspark_tpu_torch import feed, ops
    from tensorflowonspark_tpu_torch.benchmarks import make_flagship_step

    imported = time.time()
    _card_flags(torch)
    step, state, _, n_params = make_flagship_step()
    torch.cuda.synchronize()
    built = time.time()
    B = args["batch"]
    df = ctx.get_data_feed()
    batches = feed.device_prefetch(itertools.islice(
        df.iter_batches(B, numpy=True), args["steps"]), depth=2)
    waits, rows = [], [0]

    def next_batch():
        t = time.monotonic()
        batch = next(batches)
        waits.append(time.monotonic() - t)
        rows[0] += batch.shape[0]
        return batch.long()

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, next_batch(), None)          # warm-up
    losses = [m["loss"]]
    m["loss"].item()
    first_step = time.time()
    window_ms, window_wait_ms = [], []
    for _ in range(args["windows"]):
        torch.cuda.synchronize()
        t, w0 = time.monotonic(), len(waits)
        for _ in range(args["window"]):
            state, m = step(state, next_batch(), None)
            losses.append(m["loss"])
        m["loss"].item()              # the readback closes the window
        window_ms.append((time.monotonic() - t) * 1000.0 / args["window"])
        window_wait_ms.append(sum(waits[w0:]) * 1000.0 / args["window"])
    launches = ops.launch_counts(ops.TRAINING_KERNELS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the rest of the feed (none is expected): read until the driver's
    # shutdown ends it, so every fed row is accounted for
    extra = sum(len(b) for b in df.iter_batches(B, numpy=True))
    out = dict(
        losses=[x.item() for x in losses], window_step_ms=window_ms,
        window_feed_wait_ms=window_wait_ms,
        feed_wait_ms=[w * 1000.0 for w in waits], rows_seen=rows[0],
        rows_after_steps=extra, ring_attached=df._ring is not None,
        launches=launches, n_leaves=len(list(state.params.parameters())),
        n_params=n_params, max_memory_allocated_gb=peak_gb,
        device=torch.cuda.get_device_name(0),
        cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
        torch_preloaded=torch_preloaded, started=t0,
        torch_imported=imported, model_built=built,
        first_step_done=first_step, pid=os.getpid())
    with open(os.path.join(ctx.working_dir, "fed_train.json"), "w") as f:
        json.dump(out, f)


def score_model(torch, dev, seed):
    """A fresh full-depth FLAGSHIP_LM_V2 (f32 masters, bf16 compute) with
    random weights from ``seed``, for phase 10's scoring."""
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_LM_V2
    from tensorflowonspark_tpu_torch.models.transformer import (
        Transformer, TransformerConfig)

    with torch.device(dev):
        model = Transformer(TransformerConfig(**FLAGSHIP_LM_V2))
    model.reset_parameters(torch.Generator(dev).manual_seed(seed))
    return model.eval()


def row_scores(torch, model, batch):
    """Each row's mean next-token loss (f32 logsumexp minus the gold
    logit, as ``lm_loss``) from one eval forward without autograd."""
    with torch.no_grad():
        logits = model(batch[:, :-1]).float()
        gold = torch.gather(logits, -1, batch[:, 1:, None])[..., 0]
        return (torch.logsumexp(logits, -1) - gold).mean(-1).tolist()


def fed_score_fn(args, ctx):
    """Phase 10's inference map_fun: scores every fed row (a batch of at
    most ``args["batch"]`` rows, cut at partition ends) with
    :func:`score_model` and returns the scores 1:1 through the DataFeed."""
    import torch
    from tensorflowonspark_tpu_torch import ops
    from tensorflowonspark_tpu_torch.device import resolve

    _card_flags(torch)
    dev = resolve()
    model = score_model(torch, dev, args["seed"])
    df = ctx.get_data_feed(train_mode=False)
    ops.reset_launch_counts()
    rows = []
    while not df.should_stop():
        batch = df.next_numpy_batch(args["batch"])
        if batch is None or not len(batch):
            continue
        rows.append(len(batch))
        df.batch_results(row_scores(
            torch, model, torch.from_numpy(batch).to(dev).long()))
    with open(os.path.join(ctx.working_dir, "fed_score.json"), "w") as f:
        json.dump({"batches": rows, "launches": ops.launch_counts(
            ("flash_fwd",)), "device": torch.cuda.get_device_name(0)}, f)


_GPU_INFO_PROBE = """
import json, sys
from tensorflowonspark_tpu_torch import gpu_info
out = {"count": gpu_info._count_local_chips(),
       "info": gpu_info.get_accelerator_info()}
try:
    gpu_info.assign_chips(1, 1)
    out["oversubscribed"] = None
except RuntimeError as e:
    out["oversubscribed"] = str(e)
out["assigned"] = gpu_info.assign_chips(1, 0)
out["torch_imported"] = "torch" in sys.modules
print(json.dumps(out))
"""


def phase_gpu_info(torch):
    """``gpu_info`` in a fresh process (which must not initialise CUDA):
    its count against ``torch.cuda.device_count()``, ``assign_chips(1,
    1)`` refused as oversubscription on one GPU, ``assign_chips(1, 0)``
    giving ``CUDA_VISIBLE_DEVICES=0``."""
    res = subprocess.run([sys.executable, "-c", _GPU_INFO_PROBE], cwd=HERE,
                         env=dict(os.environ, PYTHONPATH=HERE),
                         capture_output=True, text=True, timeout=120)
    if res.returncode:
        raise AssertionError(f"gpu_info probe failed:\n{res.stderr}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["torch_device_count"] = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                         text=True, timeout=60)
    out["nvidia_smi_gpus"] = sum(1 for line in smi.stdout.splitlines()
                                 if line.startswith("GPU "))
    if out["count"] != out["torch_device_count"]:
        raise AssertionError(f"gpu_info counts {out['count']} GPUs, torch "
                             f"{out['torch_device_count']}")
    if out["torch_device_count"] == 1 and not (
            out["oversubscribed"] and "oversubscription"
            in out["oversubscribed"]):
        raise AssertionError(f"assign_chips(1, 1) on one GPU: "
                             f"{out['oversubscribed']!r}")
    if out["assigned"] != "0" or out["torch_imported"]:
        raise AssertionError(f"assign_chips(1, 0): {out}")
    return out


def phase_cluster(torch, dev, direct_step_ms):
    """Phase 10: a one-executor, spawn-started ``LocalBackend`` cluster
    trains the full-depth flagship from partitions fed through the shm
    ring and DataFeed (:func:`fed_train_fn`), then scores rows through
    ``c.inference`` (:func:`fed_score_fn`); both are held to the same
    seeded work run directly in this process over the same batches.  A
    failure aborts the cluster (its processes killed) and propagates."""
    import numpy as np

    from tensorflowonspark_tpu_torch import backend, cluster
    from tensorflowonspark_tpu_torch.benchmarks import (
        FLAGSHIP_BATCH, FLAGSHIP_LM_V2, make_flagship_step)

    B, S = FLAGSHIP_BATCH, FLAGSHIP_LM_V2["max_seq_len"]
    vocab, layers = FLAGSHIP_LM_V2["vocab_size"], FLAGSHIP_LM_V2["n_layers"]
    rows = cluster_rows(SEED, B * CLUSTER_STEPS, vocab, S)
    half = len(rows) // 2
    parts = [list(rows[:half]), list(rows[half:])]
    root = os.path.join(HERE, "build", "chip_smoke", "cluster")
    shutil.rmtree(root, ignore_errors=True)
    args = dict(batch=B, steps=CLUSTER_STEPS, windows=CLUSTER_WINDOWS,
                window=CLUSTER_WINDOW)
    torch.cuda.empty_cache()
    t0 = time.time()
    c = cluster.run(
        backend.LocalBackend(1, workdir=os.path.join(root, "train"),
                             start_method="spawn"),
        fed_train_fn, args, num_executors=1,
        input_mode=cluster.InputMode.SPARK, num_chips=1,
        reservation_timeout=300)
    registered = time.time()
    try:
        c.train(parts, feed_timeout=600)
        c.shutdown(timeout=600)
    except BaseException:
        c.abort()
        raise
    with open(os.path.join(root, "train", "executor-0",
                           "fed_train.json")) as f:
        fed = json.load(f)

    # the same seeded step, run directly here over the same batches
    step, state, _, _ = make_flagship_step()
    batches = [torch.from_numpy(rows[i * B:(i + 1) * B]).to(dev).long()
               for i in range(CLUSTER_STEPS)]
    direct, times = [], []
    state, m = step(state, batches[0], None)
    direct.append(m["loss"])
    for w in range(CLUSTER_WINDOWS):
        torch.cuda.synchronize()
        t = time.monotonic()
        for i in range(CLUSTER_WINDOW):
            state, m = step(state, batches[1 + w * CLUSTER_WINDOW + i], None)
            direct.append(m["loss"])
        m["loss"].item()
        times.append((time.monotonic() - t) * 1000.0 / CLUSTER_WINDOW)
    direct = [x.item() for x in direct]
    del step, state, batches, m
    torch.cuda.empty_cache()

    n_rows, n_leaves = len(rows), fed["n_leaves"]
    if fed["rows_seen"] != n_rows or fed["rows_after_steps"]:
        raise AssertionError(f"fed {n_rows} rows, the node saw "
                             f"{fed['rows_seen']} + "
                             f"{fed['rows_after_steps']}")
    if not fed["ring_attached"]:
        raise AssertionError("the feed did not ride the shm ring")
    if fed["torch_preloaded"]:
        raise AssertionError("the executor loaded torch before forking "
                             "the node process")
    want = {name: layers * CLUSTER_STEPS for name in
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    want.update(adamw=n_leaves * CLUSTER_STEPS, lion=0)
    if fed["launches"] != want:
        raise AssertionError(f"node launches {fed['launches']}, want "
                             f"{want}")
    if fed["losses"] != direct:
        raise AssertionError(f"fed losses {fed['losses']} differ from the "
                             f"direct loop's {direct}")

    # inference: a fresh seeded model scores rows 1:1, in order
    score = cluster_rows(SEED + 1, CLUSTER_SCORE_ROWS, vocab, S)
    sparts = [list(score[:CLUSTER_SCORE_ROWS // 2]),
              list(score[CLUSTER_SCORE_ROWS // 2:])]
    sargs = dict(batch=B, seed=SEED + 2)
    c = cluster.run(
        backend.LocalBackend(1, workdir=os.path.join(root, "score"),
                             start_method="spawn"),
        fed_score_fn, sargs, num_executors=1,
        input_mode=cluster.InputMode.SPARK, num_chips=1,
        reservation_timeout=300)
    try:
        scores = c.inference(sparts)
        c.shutdown(timeout=600)
    except BaseException:
        c.abort()
        raise
    with open(os.path.join(root, "score", "executor-0",
                           "fed_score.json")) as f:
        fed_score = json.load(f)
    model = score_model(torch, dev, sargs["seed"])
    want_scores = []
    for part in sparts:
        for i in range(0, len(part), B):
            batch = torch.from_numpy(np.stack(part[i:i + B])).to(dev).long()
            want_scores += row_scores(torch, model, batch)
    del model
    torch.cuda.empty_cache()
    if scores != want_scores:
        raise AssertionError(f"cluster scores {scores} differ from direct "
                             f"scoring {want_scores}")
    n_batches = -(-CLUSTER_SCORE_ROWS // B)
    if fed_score["launches"]["flash_fwd"] != layers * n_batches:
        raise AssertionError(f"scoring launched flash_fwd "
                             f"{fed_score['launches']['flash_fwd']} times")
    shutil.rmtree(root, ignore_errors=True)

    fed_step_ms = min(fed["window_step_ms"])
    # the feed's delivery rate while the consumer waits on it, after the
    # first batch (which waits for the feeder task to start)
    waits = fed["feed_wait_ms"][1:]
    wait_s = sum(waits) / 1000.0
    row_bytes = rows.itemsize * rows.shape[1]
    loop_s = fed["first_step_done"] - fed["model_built"] + sum(
        fed["window_step_ms"]) * CLUSTER_WINDOW / 1000.0
    return dict(
        config="FLAGSHIP_LM_V2", batch=B, seq=S, steps=CLUSTER_STEPS,
        rows=n_rows, partitions=len(parts), bytes_per_step=B * row_bytes,
        fed_step_ms=fed_step_ms, fed_window_step_ms=fed["window_step_ms"],
        direct_step_ms=min(times), direct_window_step_ms=times,
        phase8_direct_step_ms=direct_step_ms,
        fed_over_direct=fed_step_ms / min(times),
        feed_wait_ms_per_step=sum(waits) / len(waits),
        feed_wait_ms_first_batch=fed["feed_wait_ms"][0],
        window_feed_wait_ms=fed["window_feed_wait_ms"],
        feed_rows_per_s=(n_rows - B) / wait_s,
        feed_mb_per_s=(n_rows - B) * row_bytes / wait_s / 1e6,
        train_rows_per_s=n_rows / loop_s,
        spawn_to_registered_s=registered - t0,
        spawn_to_first_step_s=fed["first_step_done"] - t0,
        node_torch_import_s=fed["torch_imported"] - fed["started"],
        node_model_build_s=fed["model_built"] - fed["torch_imported"],
        losses=fed["losses"], losses_equal=True,
        launches=fed["launches"], n_leaves=n_leaves,
        node_max_memory_allocated_gb=fed["max_memory_allocated_gb"],
        node_device=fed["device"],
        node_cuda_visible_devices=fed["cuda_visible_devices"],
        scored_rows=len(scores), score_batches=fed_score["batches"],
        scores_equal=True, score_launches=fed_score["launches"],
        scores=scores)


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
    built = ptxas_kernels(info["ptxas"])
    emit("build", seconds=info["seconds"], library=_build.LIBRARY,
         ptxas=built)
    # a kernel whose spill line was not read counts as spilling
    spills = [name for name, k in built.items()
              if any(frag in name for frag in NO_SPILL)
              and k.get("spill_stores", 1) + k.get("spill_loads", 1)]
    if not all(any(frag in name for name in built) for frag in NO_SPILL) \
            or spills:
        raise AssertionError(f"kernels that must not spill spill or are "
                             f"missing from the ptxas report: {spills}")

    floor_ms = launch_floor_ms()
    emit("launch_floor", floor_ms=floor_ms, nvidia_smi=card)

    rows = phase_kernels(torch, F, dev)
    attach_ptxas(rows, built)
    attach_floor(rows, floor_ms)
    for row in rows.values():
        emit("kernel", **row)
    torch.cuda.empty_cache()

    parity = phase_parity(torch, dev)
    emit("parity", steps=parity)
    torch.cuda.empty_cache()

    from tensorflowonspark_tpu_torch import ops, quantize
    from tensorflowonspark_tpu_torch.benchmarks import FLAGSHIP_LM

    cfg, export_dir, n_params = make_flagship_export(torch, dev)
    try:
        launches, main_path = phase_main_path(torch, dev, cfg, export_dir)
        splits = dict(main_path["launches_by_shape"])
        emit("main_path", nvidia_smi=card, params=n_params, **main_path)
        torch.cuda.empty_cache()

        quant_rows = phase_quant_kernels(torch, F, dev)
        attach_ptxas(quant_rows, built)
        attach_floor(quant_rows, floor_ms)
        for row in quant_rows.values():
            emit("kernel", **row)
        rows.update(quant_rows)
        torch.cuda.empty_cache()

        emit("quant_parity", **phase_quant_parity(torch, dev))
        torch.cuda.empty_cache()

        for mode in quantize.MODES:
            q_launches, q_main = phase_main_path(torch, dev, cfg, export_dir,
                                                 quantize=mode)
            emit("quant_main_path", nvidia_smi=card, params=n_params,
                 bf16_resident_weight_bytes=main_path[
                     "resident_weight_bytes"],
                 bf16_memory_allocated_by_load=main_path[
                     "memory_allocated_by_load"], **q_main)
            launches[f"{mode}_matmul"] = q_launches[f"{mode}_matmul"]
            splits[f"{mode}_matmul"] = q_main["launches_by_shape"][
                f"{mode}_matmul"]
            torch.cuda.empty_cache()

        s4_rows = phase_int8_kernels(torch, F, dev)
        s4_rows.update(phase_layernorm_kernel(torch, F, dev))
        attach_ptxas(s4_rows, built)
        attach_floor(s4_rows, floor_ms)
        for row in s4_rows.values():
            emit("kernel", **row)
        rows.update(s4_rows)
        torch.cuda.empty_cache()

        emit("slice4_parity", **phase_slice4_parity(torch, dev))
        torch.cuda.empty_cache()

        # the int8 kv pool, with bf16 and with int8 weights (the
        # deployment of llama_serve.py --quantize int8 --kv_dtype int8)
        for mode in ("none", "int8"):
            kv_launches, kv_main = phase_main_path(
                torch, dev, cfg, export_dir, quantize=mode, kv_dtype="int8")
            emit("kv_int8_main_path", nvidia_smi=card, params=n_params,
                 bf16_kv_pool_bytes=main_path["kv_pool_bytes"],
                 bf16_memory_allocated_by_load=main_path[
                     "memory_allocated_by_load"], **kv_main)
            if mode == "none":
                for name in ops.SERVING_KERNELS_INT8_KV:
                    launches[name] = kv_launches[name]
                    splits[name] = kv_main["launches_by_shape"][name]
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(export_dir, ignore_errors=True)

    # FLAGSHIP_LM (LayerNorm) at full depth with the fused LayerNorm
    ln_cfg, ln_dir, ln_params = make_flagship_export(
        torch, dev, FLAGSHIP_LM, name="export_fused_ln", fused_ln=True)
    try:
        ln_launches, ln_main = phase_main_path(torch, dev, ln_cfg, ln_dir)
        emit("fused_ln_main_path", nvidia_smi=card, params=ln_params,
             bf16_rmsnorm_memory_allocated_by_load=main_path[
                 "memory_allocated_by_load"], **ln_main)
        launches["layernorm"] = ln_launches["layernorm"]
        splits["layernorm"] = ln_main["launches_by_shape"]["layernorm"]
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ln_dir, ignore_errors=True)

    train_rows = phase_train_kernels(torch, F, dev)
    train_rows.update(phase_lion_kernel(torch, dev))
    attach_ptxas(train_rows, built)
    attach_floor(train_rows, floor_ms)
    for row in train_rows.values():
        emit("kernel", **row)
    rows.update(train_rows)
    emit("lse_path", **phase_lse_path(torch, dev))
    torch.cuda.empty_cache()

    emit("train_parity", **phase_opt_parity(torch, dev, None))
    torch.cuda.empty_cache()
    # adamw8bit takes two steps: its first moves each element by about
    # +-lr whatever its int8 state holds; the second reads it back
    for name, steps in (("lion_fused", 1), ("adamw8bit", 2),
                        ("adafactor", 1)):
        emit("optimizer_parity",
             **phase_opt_parity(torch, dev, name, steps))
        torch.cuda.empty_cache()

    train_launches, train_main = phase_train_main(torch, dev)
    emit("train_main_path", nvidia_smi=card, **train_main)
    launches.update(train_launches)
    torch.cuda.empty_cache()

    lion_launches, lion_main = phase_train_main(torch, dev, "lion_fused")
    emit("lion_main_path", nvidia_smi=card,
         adamw_fused_step_ms=train_main["step_ms"],
         adamw_fused_max_memory_allocated_gb=train_main[
             "max_memory_allocated_gb"], **lion_main)
    launches["lion"] = lion_launches["lion"]
    torch.cuda.empty_cache()
    for name in ("adamw8bit", "adafactor"):
        _, opt_main = phase_train_main(torch, dev, name, windows=1,
                                       window=3, profile=False,
                                       must_fall=False)
        emit("optimizer_main_path", nvidia_smi=card,
             adamw_fused_step_ms=train_main["step_ms"],
             adamw_fused_max_memory_allocated_gb=train_main[
                 "max_memory_allocated_gb"], **opt_main)
        torch.cuda.empty_cache()

    emit("gpu_info", nvidia_smi=card, **phase_gpu_info(torch))
    emit("cluster_main_path", nvidia_smi=card,
         **phase_cluster(torch, dev, train_main["step_ms"]))
    torch.cuda.empty_cache()

    # the serving kernels' launches by shape, each from its own main path
    emit("launch_split", nvidia_smi=card, kernels=splits)
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
