"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    rope="none", norm="layernorm", act="gelu", glu=False,
    expand_factor=2.0, conv_width=4,
    tie_embeddings=True, sub_quadratic=True,
)
