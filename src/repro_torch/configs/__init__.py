"""Architecture configs. One module per assigned architecture + the paper's
own Llama2 family. ``get_config(name)`` / ``list_configs()`` are the API."""

from repro_torch.configs.base import (
    ModelConfig, ParallelConfig, ShapeConfig, SHAPES,
    get_config, list_configs, register, smoke_config,
)

# import for registration side-effects
from repro_torch.configs import (  # noqa: F401
    whisper_small, deepseek_7b, qwen3_32b, deepseek_67b, mistral_nemo_12b,
    dbrx_132b, deepseek_v3_671b, jamba_v01_52b, rwkv6_3b, chameleon_34b,
    llama2,
)

__all__ = [
    "ModelConfig", "ParallelConfig", "ShapeConfig", "SHAPES",
    "get_config", "list_configs", "register", "smoke_config",
]
