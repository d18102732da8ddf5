"""The flagship configurations the port is sized against (copies of the
JAX package's ``benchmarks`` dicts; the port imports nothing from that
package)."""

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
