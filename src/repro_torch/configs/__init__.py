from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, ShapeConfig, ScanGroup, SHAPES,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, shape_applies,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS, PENDING, get_arch, get_shape,
)
