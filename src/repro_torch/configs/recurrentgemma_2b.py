"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 2:1 [arXiv:2402.19427; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("rec", "rec", "attn"),
    window_size=2048, rope="full", norm="rmsnorm", act="gelu", glu=True,
    expand_factor=1.0, conv_width=4,
    tie_embeddings=True, sub_quadratic=True,
)
