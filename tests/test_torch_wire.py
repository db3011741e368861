"""The port's wire against the JAX package's, byte for byte, on the CPU.

- `wire.packer` (the port's msgpack subset) vs `msgpack` itself: packing is
  byte-identical to `msgpack.packb(x, use_bin_type=True)` and unpacking
  inverts msgpack's output, over hypothesis-drawn nested maps and arrays
  and msgpack's int width edges.
- The tensor codec: every wire dtype (bf16 included) under the raw, zlib
  and zstd codecs, raw and compressed (byte split for 2-byte dtypes): the
  port's meta and payload equal the JAX codec's for the same values, and
  each package decodes the other's bytes.
- Frames: the port's `_encode_frame` equals the JAX one.
- RPC: a JAX connection makes a unary call and runs a stream on a port
  `RpcServer`, and the reverse.
- Without zstd (taken out of the port's codec registry, as on a machine
  without `zstandard`): port peers exchange zlib frames, a JAX peer that
  has read the port's advert sends only zlib, and a zstd payload fails
  with an error naming the codec.
"""

import asyncio

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bloombee_tpu.wire import rpc as j_rpc
from bloombee_tpu.wire import tensor_codec as j_codec
from bloombee_tpu_torch.wire import packer
from bloombee_tpu_torch.wire import rpc as t_rpc
from bloombee_tpu_torch.wire import tensor_codec as t_codec

INT_EDGES = [
    0, 1, 127, 128, 255, 256, 2**15, 2**16 - 1, 2**16, 2**31, 2**32 - 1,
    2**32, 2**63, 2**64 - 1, -1, -32, -33, -2**7, -2**7 - 1, -2**15,
    -2**15 - 1, -2**31, -2**31 - 1, -2**63,
]

scalars = (
    st.none() | st.booleans()
    | st.integers(min_value=-2**63, max_value=2**64 - 1)
    | st.sampled_from(INT_EDGES)
    | st.floats(allow_nan=False) | st.text() | st.binary()
)
values = st.recursive(
    scalars,
    lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=40), inner, max_size=20),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None)
@given(values)
def test_packer_matches_msgpack(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert packer.packb(value) == want
    assert packer.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("value", [
    INT_EDGES,
    {"s" * n: "v" * n for n in (0, 31, 32, 255, 256, 70000)},
    [b"b" * n for n in (0, 255, 256, 70000)],
    [list(range(n)) for n in (15, 16, 70000)],
    {str(i): i for i in range(70000)},
    (1, (2.5, -0.0, float("inf")), None, True, False),
], ids=["ints", "str-widths", "bin-widths", "array-widths", "map-16-bit",
        "tuple-float"])
def test_packer_widths_match_msgpack(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert packer.packb(value) == want
    assert packer.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_packer_rejects_what_msgpack_rejects():
    for bad in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            packer.packb(bad)
    with pytest.raises(TypeError):
        packer.packb({"x": object()})
    with pytest.raises(ValueError, match="extra data"):
        packer.unpackb(msgpack.packb(1) + b"\x00")


WIRE_DTYPES = ["f32", "f16", "bf16", "i32", "i64", "u8", "bool", "f64"]


def _tensor(name: str, n: int) -> torch.Tensor:
    """n values of wire dtype `name`, compressible enough that the large
    size ships compressed."""
    rng = np.random.default_rng(n)
    if name == "bool":
        return torch.from_numpy(rng.random(n) > 0.7)
    x = np.round(rng.standard_normal(n) * 4)
    return torch.from_numpy(x).to(t_codec.dtype_for_name(name))


@pytest.mark.parametrize("codec", ["raw", "zlib", "zstd"])
@pytest.mark.parametrize("name", WIRE_DTYPES)
def test_tensor_codec_matches_jax(name, codec):
    allowed = frozenset({"raw", codec})
    # 17 values ship raw; 40000 pass the 48 KiB compression gate (byte
    # split for 2-byte dtypes) except one-byte ones, which also ship raw
    for n in (17, 40000):
        t = _tensor(name, n).reshape(-1, 1)
        meta, payload = t_codec.serialize_tensor(t, allowed=allowed)
        j_arr = j_codec.deserialize_tensor(
            j_codec.TensorMeta.from_wire(meta.to_wire()), payload
        )
        np.testing.assert_array_equal(
            np.asarray(j_arr, np.float64), t.double().numpy()
        )
        j_meta, j_payload = j_codec.serialize_tensor(j_arr, allowed=allowed)
        assert j_meta.to_wire() == meta.to_wire()
        assert bytes(j_payload) == bytes(payload)
        back = t_codec.deserialize_tensor(
            t_codec.TensorMeta.from_wire(j_meta.to_wire()),
            memoryview(j_payload),
        )
        assert back.dtype == t.dtype and torch.equal(back, t)
        if n > 17 and t.element_size() > 1 and codec != "raw":
            assert meta.codec == codec
            assert meta.byte_split == (t.element_size() == 2)


def test_encode_frame_matches_jax():
    tensors = [_tensor("bf16", 30000).reshape(100, 300), _tensor("i64", 5)]
    tm, blobs = t_codec.serialize_tensors(tensors)
    header = {"t": "sitem", "id": 7, "meta": {"step": 3, "route": [
        {"host": "127.0.0.1", "port": 40000, "session_id": "sess-1"}
    ], "deadline_s": 119.5, "tree": False}, "tm": tm, "cd": ["raw", "zlib"]}
    assert t_rpc._encode_frame(header, blobs) == j_rpc._encode_frame(
        header, blobs
    )


async def _echo_unary(meta, tensors):
    return {"got": meta, "n": len(tensors)}, list(tensors)


async def _echo_stream(stream):
    while True:
        item = await stream.recv()
        if item is None:
            break
        meta, tensors = item
        await stream.send({"echo": meta.get("i")}, tensors)
    await stream.close()


async def _round_trip(server_mod, client_mod, tensors):
    server = server_mod.RpcServer(
        unary_handlers={"echo": _echo_unary},
        stream_handlers={"echo_stream": _echo_stream},
        host="127.0.0.1",
    )
    await server.start()
    conn = await client_mod.connect("127.0.0.1", server.port)
    try:
        meta, out = await conn.call("echo", {"x": [1, "a"]}, tensors)
        stream = await conn.open_stream("echo_stream", {"open": True})
        got = []
        for i in range(3):
            await stream.send({"i": i}, tensors)
            got.append(await stream.recv())
        await stream.close()
        assert await stream.recv() is None
        return meta, out, got, conn.peer_codecs
    finally:
        await conn.close()
        await server.stop()


@pytest.mark.parametrize("direction", ["jax-client", "port-client"])
def test_rpc_interop(direction):
    """Unary call and stream between the two packages' rpc, both ways:
    metas and tensors arrive intact, and each side reads the other's codec
    advert."""
    server_mod, client_mod = (
        (t_rpc, j_rpc) if direction == "jax-client" else (j_rpc, t_rpc)
    )
    torch_in = [_tensor("bf16", 40000).reshape(200, 200), _tensor("i32", 3)]
    if client_mod is j_rpc:
        import ml_dtypes

        tensors = [np.asarray(torch_in[0].float()).astype(ml_dtypes.bfloat16),
                   torch_in[1].numpy()]
    else:
        tensors = torch_in
    meta, out, items, peer_codecs = asyncio.run(
        _round_trip(server_mod, client_mod, tensors)
    )
    assert meta == {"got": {"x": [1, "a"]}, "n": 2}
    assert [m for m, _ in items] == [{"echo": i} for i in range(3)]
    for got in [out] + [t for _, t in items]:
        for g, want in zip(got, torch_in, strict=True):
            g = torch.from_numpy(np.asarray(g, np.float64)) if isinstance(
                g, np.ndarray) else g.double()
            assert torch.equal(g, want.double())
    assert "zlib" in peer_codecs


def test_without_zstd(monkeypatch):
    """zstd taken out of the port's registry: the port advertises raw and
    zlib only; port peers exchange zlib; a JAX peer that has read that
    advert sends zlib; a zstd payload names the missing codec."""
    monkeypatch.delitem(t_codec._CODECS, "zstd")
    assert t_codec.supported_codecs() == {"raw", "zlib"}
    codecs_sent = []
    for mod in (t_rpc, j_rpc):
        real = mod._frame_buffers

        def spy(header, blobs, _real=real):
            codecs_sent.extend(m["c"] for m in header.get("tm") or [])
            return _real(header, blobs)

        monkeypatch.setattr(mod, "_frame_buffers", spy)
    big = _tensor("bf16", 40000).reshape(200, 200)

    async def run():
        server = t_rpc.RpcServer(
            unary_handlers={"echo": _echo_unary}, host="127.0.0.1"
        )
        await server.start()
        try:
            port_conn = await t_rpc.connect("127.0.0.1", server.port)
            _, out = await port_conn.call("echo", {}, [big])
            assert torch.equal(out[0], big)
            await port_conn.close()
            assert set(codecs_sent) == {"zlib"}
            codecs_sent.clear()
            jax_conn = await j_rpc.connect("127.0.0.1", server.port)
            await jax_conn.call("echo", {}, [])  # the port's advert arrives
            assert jax_conn.peer_codecs == {"raw", "zlib"}
            arr = np.asarray(big.float()).astype(j_codec.dtype_for_name(
                "bf16"))
            _, out = await jax_conn.call("echo", {}, [arr])
            assert np.array_equal(np.asarray(out[0], np.float32),
                                  big.float().numpy())
            await jax_conn.close()
            assert set(codecs_sent) == {"zlib"}
        finally:
            await server.stop()

    asyncio.run(run())
    meta, payload = j_codec.serialize_tensor(
        np.asarray(big.float()).astype(j_codec.dtype_for_name("bf16")),
        allowed=frozenset({"raw", "zstd"}),
    )
    assert meta.codec == "zstd"
    with pytest.raises(ValueError, match="zstd"):
        t_codec.deserialize_tensor(
            t_codec.TensorMeta.from_wire(meta.to_wire()), payload
        )


def test_zstd_round_trips_across_codec_threads():
    """The codec pool (de)compresses on several threads at once, and a zstd
    (de)compressor object must not be shared by two of them: every round
    trip stays exact with four threads at work."""
    from concurrent.futures import ThreadPoolExecutor

    tensors = [_tensor("bf16", 40000 + i) for i in range(8)]

    def round_trip(t):
        for _ in range(6):
            meta, payload = t_codec.serialize_tensor(
                t, allowed=frozenset({"raw", "zstd"})
            )
            assert meta.codec == "zstd"
            assert torch.equal(t_codec.deserialize_tensor(meta, payload), t)

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(round_trip, tensors))
