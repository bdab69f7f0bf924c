"""Models: the GPT-2 / Llama decoder-only Transformer and its presets."""

from dlrover_tpu_torch.models.gpt2 import gpt2_config  # noqa: F401
from dlrover_tpu_torch.models.llama import (  # noqa: F401
    llama_config,
    moe_llama_config,
)
from dlrover_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    TransformerLM,
    init_params,
)
