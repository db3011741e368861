"""Model families of the port: Llama, Mistral, Qwen2 and Qwen3, registered
in `models.auto`."""

from bloombee_tpu_torch.models.spec import ModelSpec

__all__ = ["ModelSpec"]
