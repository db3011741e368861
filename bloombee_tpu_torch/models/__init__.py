"""Model families of the port (Llama only in this slice)."""

from bloombee_tpu_torch.models.spec import ModelSpec

__all__ = ["ModelSpec"]
