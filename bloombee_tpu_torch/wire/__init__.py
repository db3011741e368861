"""Wire plane of the port (a copy of bloombee_tpu/wire/): tensor
serialization with lossless compression, async RPC over length-prefixed
msgpack frames on TCP. The frames are byte-compatible with the JAX
package's, over the port's own msgpack subset (`packer`) and torch tensor
codec, so port and JAX peers talk to each other.
"""

from bloombee_tpu_torch.wire.tensor_codec import (
    LEGACY_WIRE_CODECS,
    deserialize_tensor,
    deserialize_tensors,
    serialize_tensor,
    serialize_tensors,
    supported_codecs,
)
from bloombee_tpu_torch.wire.pipeline import CodecPipeline
from bloombee_tpu_torch.wire.rpc import (
    Connection,
    RpcError,
    RpcServer,
    connect,
)

__all__ = [
    "serialize_tensor",
    "deserialize_tensor",
    "serialize_tensors",
    "deserialize_tensors",
    "supported_codecs",
    "LEGACY_WIRE_CODECS",
    "CodecPipeline",
    "Connection",
    "RpcServer",
    "RpcError",
    "connect",
]
