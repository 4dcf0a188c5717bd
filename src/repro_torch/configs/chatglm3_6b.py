"""chatglm3-6b [dense] — RoPE 2d, GQA [arXiv:2406.12793; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024,
    rope="2d", norm="rmsnorm", act="silu", glu=True,
)
