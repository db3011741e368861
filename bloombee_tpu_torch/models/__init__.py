"""Model families of the port: Llama, Mistral, Qwen2, Qwen3, Gemma2 and
Gemma3 (with Gemma3-text), registered in `models.auto`."""

from bloombee_tpu_torch.models.spec import ModelSpec

__all__ = ["ModelSpec"]
