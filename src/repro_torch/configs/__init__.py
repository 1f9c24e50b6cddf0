"""Architecture configs.  ``get_config(arch_id)`` resolves any assigned arch."""
from repro_torch.configs.base import ArchConfig, get_config, list_archs  # noqa: F401
