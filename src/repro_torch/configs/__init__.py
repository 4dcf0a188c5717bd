from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, ShapeConfig, ScanGroup, SHAPES,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, shape_applies,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS, all_cells, arch_from_spec, arch_to_spec, get_arch,
    get_shape, shape_from_spec, shape_to_spec,
)
