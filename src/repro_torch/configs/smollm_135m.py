"""smollm-135m [dense] — hf:HuggingFaceTB/SmolLM-135M.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152 — small llama arch,
tied embeddings.  9 heads do not divide the 16-way model axis: attention
stays replicated on 'model' while the MLP shards (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
)
