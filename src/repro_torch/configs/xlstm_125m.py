"""xlstm-125m [ssm] — arXiv:2405.04517 (unverified).

12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM blocks; the blocks
carry their own up-projections (mLSTM pre-up x2, sLSTM post-up 4/3 gated),
hence d_ff=0 in the assigned spec.  Pattern (m,m,m,s) x3 ≈ the paper's
mLSTM-heavy ratios.  long_500k runs: both cell states are O(1) per token.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
)
