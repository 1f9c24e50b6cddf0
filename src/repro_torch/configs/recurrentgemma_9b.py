"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 / Griffin (unverified).

Assigned spec: 38L d_model=4096 16H (GQA kv=1) d_ff=12288, RG-LRU + local
attention 1:2 (pattern rec,rec,attn; 38 = 12x3 + 2 rec tail).  Local window
2048, MQA (kv=1) for the attention blocks, GeGLU MLP.
long_500k runs: RG-LRU state is O(1), local-attn KV bounded by the window.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    mlp_act="gelu",
    mlp_gated=True,
    block_pattern=("rglru", "rglru", "attn_chunked"),
    attn_chunk=2048,
    local_window=2048,
    lru_width=4096,
    train_microbatches=4,
)
