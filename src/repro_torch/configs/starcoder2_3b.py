"""starcoder2-3b [dense] — GQA, RoPE, sliding window [arXiv:2402.19173; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    d_ff=12288, vocab_size=49152,
    window_size=4096, rope="full", norm="layernorm", act="gelu", glu=False,
    tie_embeddings=True,
)
