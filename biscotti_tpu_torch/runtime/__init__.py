"""The runtime's JAX-free planes, as the port's own copies of
`biscotti_tpu/runtime/`: the wire codecs (`codecs.py`), the frame format
(`messages.py`), the block and update packers (`wire.py`), the protocol
feature table (`protocol.py`) and the asyncio RPC layer (`rpc.py`). The
peer agent (`runtime/peer.py`) is not ported yet."""
