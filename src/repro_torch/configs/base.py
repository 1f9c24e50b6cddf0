"""ArchConfig — the framework's model configuration schema.

Port of ``repro/configs/base.py``, field for field: the port keeps its own
copy (it imports nothing of ``repro``, not even this JAX-free module).
Every assigned architecture is a ``repro_torch/configs/<id>.py`` exporting
``CONFIG``; reduced smoke variants come from :meth:`ArchConfig.smoke`.
The tables are data: all ten are here, and ``repro_torch.models`` builds,
serves and trains each of them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | audio | vlm | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int              # raw; padded to %256 at build time
    head_dim: Optional[int] = None

    # --- attention/block options ------------------------------------------
    qk_norm: bool = False
    mlp_act: str = "silu"        # silu | relu2 | gelu
    mlp_gated: bool = True
    norm: str = "rms"            # rms | ln
    pos: str = "rope"            # rope | learned | none
    rope_theta: float = 10000.0
    attn_chunk: Optional[int] = None   # local/chunked attention window
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None

    # --- layer pattern -----------------------------------------------------
    # cycled over layers; entries: attn | attn_chunked | rglru | mlstm | slstm
    block_pattern: Tuple[str, ...] = ("attn",)

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    expert_capacity_factor: float = 1.25

    # --- recurrent forms -------------------------------------------------------
    mlstm_form: str = "chunkwise"        # chunkwise (TPU matmul form) | sequential

    # --- recurrent widths ----------------------------------------------------
    lru_width: Optional[int] = None      # rglru state width (default d_model)
    local_window: int = 2048             # rglru local-attention window

    # --- encoder-decoder / frontends -----------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500              # whisper frame count
    frontend: Optional[str] = None       # audio_stub | vision_stub
    vis_tokens: int = 256                # vlm patch-embedding prefix length

    # --- serving ---------------------------------------------------------------
    kv_cache_dtype: str = "bf16"         # bf16 | int8 (quantized KV cache)

    # --- training -------------------------------------------------------------
    fsdp: bool = False                   # shard params/grads over `data` too
    optimizer: str = "adamw"             # adamw | adafactor
    remat: str = "full"                  # full | dots | none
    train_microbatches: int = 1          # grad-accumulation chunks per step
    moe_groups: int = 16                 # MoE dispatch groups (≈ data shards)

    # ------------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab_size // 256) * 256

    @property
    def supports_long_context(self) -> bool:
        """True iff 500K-token decode is tractable: either every temporal
        mixer has bounded state (SSM/hybrid), or most layers are
        chunked-local with only a minority of global-attention layers whose
        S-sharded KV cache fits (Llama-4 iRoPE layout)."""
        if all(b != "attn" for b in self.block_pattern):
            return True
        return self.attn_chunk is not None

    def layer_types(self) -> Tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        pat_len = len(self.block_pattern)
        n_layers = max(pat_len, 2)
        return dataclasses.replace(
            self,
            num_layers=n_layers,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 1,
            d_ff=128 if self.d_ff else 0,
            head_dim=16,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            lru_width=64 if self.lru_width or "rglru" in self.block_pattern else None,
            local_window=32,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=24,
            vis_tokens=8,
            attn_chunk=32 if self.attn_chunk else None,
            remat="none",
            train_microbatches=1,
            moe_groups=2,
        )


ASSIGNED = [
    "llama4_maverick_400b_a17b",
    "grok_1_314b",
    "deepseek_7b",
    "nemotron_4_15b",
    "smollm_135m",
    "qwen3_32b",
    "whisper_base",
    "internvl2_1b",
    "recurrentgemma_9b",
    "xlstm_125m",
]

_ALIAS = {n.replace("_", "-"): n for n in ASSIGNED}


def list_archs():
    return list(ASSIGNED)


def get_config(arch: str) -> ArchConfig:
    mod_name = _ALIAS.get(arch, arch).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
