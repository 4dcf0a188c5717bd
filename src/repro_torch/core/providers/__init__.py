"""Strategy providers (the reference's ``src/repro/core/providers/``)."""
from repro_torch.core.providers.base import (  # noqa: F401
    Provider, all_providers, get_provider, register,
)
import repro_torch.core.providers.tensor_par  # noqa: F401
import repro_torch.core.providers.fsdp        # noqa: F401
import repro_torch.core.providers.hybrid2d    # noqa: F401
import repro_torch.core.providers.expert_par  # noqa: F401
