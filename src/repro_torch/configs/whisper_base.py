"""whisper-base [audio] — arXiv:2212.04356 (unverified).

Enc-dec, 6L+6L d_model=512 8H (MHA) d_ff=2048 vocab=51865.  GELU MLP
(ungated), LayerNorm, learned positions, no rope.  The conv audio frontend
is a STUB per the assignment: input_specs() provides precomputed frame
embeddings [B, 1500, 512].  decode_32k exercises the backbone's 32K-KV
decoder path (the real model caps decoder positions at 448 — deviation
recorded in DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,              # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    mlp_act="gelu",
    mlp_gated=False,
    norm="ln",
    pos="learned",
    is_encoder_decoder=True,
    encoder_layers=6,
    encoder_seq=1500,
    frontend="audio_stub",
)
