"""internvl2-1b [vlm] — arXiv:2404.16821, hf:OpenGVLab/InternVL2-1B.

LM backbone = Qwen2-0.5B: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655.  The InternViT-300M vision tower is a STUB per the assignment:
input_specs() provides 256 precomputed patch embeddings per image, prepended
to the text sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    frontend="vision_stub",
    vis_tokens=256,
)
