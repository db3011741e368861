"""Model families of the port: Llama, Mistral, Qwen2, Qwen3, Gemma2,
Gemma3 (with Gemma3-text), Mixtral and Qwen3-MoE, registered in
`models.auto`."""

from bloombee_tpu_torch.models.spec import ModelSpec

__all__ = ["ModelSpec"]
