"""musicgen-large [audio] — decoder-only over EnCodec tokens (frontend STUB)
[arXiv:2306.05284; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    rope="none", norm="layernorm", act="gelu", glu=False,
    frontend="frame",
)
