"""qwen3-32b [dense] — hf:Qwen/Qwen3-32B (config family verified via Qwen3-8B).

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, qk-norm, head_dim=128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    train_microbatches=8,
)
