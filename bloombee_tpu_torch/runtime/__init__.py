"""Server-side compute runtime of the port: the span step and its
executor."""

from bloombee_tpu_torch.runtime.executor import SpanExecutor
from bloombee_tpu_torch.runtime.step import span_step

__all__ = ["span_step", "SpanExecutor"]
