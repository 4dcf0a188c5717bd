"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    num_experts=128, experts_per_token=8,
    rope="full", norm="rmsnorm", act="silu", glu=True,
)
