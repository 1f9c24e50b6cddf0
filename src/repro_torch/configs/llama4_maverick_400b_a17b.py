"""llama4-maverick-400b-a17b [moe] — hf:meta-llama/Llama-4-Scout-17B-16E (unverified).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts top-1.
Early fusion multimodal in the real model; assigned spec is the LM backbone.
Llama-4 uses chunked local attention (8192) on 3 of every 4 layers and global
attention (NoPE) on the 4th — that is what makes long_500k decode runnable
with bounded KV (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    attn_chunk=8192,
    block_pattern=("attn_chunked", "attn_chunked", "attn_chunked", "attn"),
    optimizer="adafactor",
    fsdp=True,   # factored stats: 400B AdamW does not fit 256x16GB
    qk_norm=True,
    train_microbatches=16,
)
