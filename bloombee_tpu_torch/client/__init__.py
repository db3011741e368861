"""Client of the port: embeddings + LM head locally, blocks via the swarm
(the counterpart of bloombee_tpu/client/).

RemoteSequenceManager (routing), InferenceSession (stateful decode with
retry, re-route and replay) and the distributed model facade with
generate(). The client's math runs in PyTorch on the client's device.
"""

from bloombee_tpu_torch.client.config import ClientConfig
from bloombee_tpu_torch.client.model import DistributedModelForCausalLM
from bloombee_tpu_torch.client.sequence_manager import RemoteSequenceManager
from bloombee_tpu_torch.client.session import InferenceSession

__all__ = [
    "RemoteSequenceManager",
    "InferenceSession",
    "DistributedModelForCausalLM",
    "ClientConfig",
]
