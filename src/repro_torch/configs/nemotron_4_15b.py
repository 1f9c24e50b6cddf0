"""nemotron-4-15b [dense] — arXiv:2402.16819 (unverified).

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
Squared-ReLU MLP (ungated), LayerNorm, no embedding tying.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_act="relu2",
    mlp_gated=False,
    norm="ln",
    train_microbatches=4,
)
