"""deepseek-7b [dense] — arXiv:2401.02954, hf:deepseek-ai/deepseek-llm-7b-base.

30L d_model=4096 32H (MHA: kv=32) d_ff=11008 vocab=102400 — llama architecture.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    kv_cache_dtype="int8",   # MHA 32-kv-head cache: bf16 does not fit 256x16GB at decode_32k
    train_microbatches=4,
)
