from bloombee_tpu_torch.models.llama.block import (
    block_forward,
    init_block_params,
)
from bloombee_tpu_torch.models.llama.config import llama_spec_from_hf

__all__ = ["block_forward", "init_block_params", "llama_spec_from_hf"]
