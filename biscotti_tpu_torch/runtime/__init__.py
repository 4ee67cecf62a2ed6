"""The runtime, as the port's own copies of `biscotti_tpu/runtime/`: the
wire codecs (`codecs.py`), the frame format (`messages.py`), the block and
update packers (`wire.py`), the protocol feature table (`protocol.py`),
the asyncio RPC layer (`rpc.py`), the JAX-free planes under the peer
(`faults.py`, `admission.py`, `stragglers.py`, `overlay.py`,
`placement.py`, `membership.py`, `adversary.py`) and the live peer agent
(`peer.py::PeerAgent`, on the device its caller names), the hive of
co-hosted peers (`hive.py`) and the device cluster on a batched stepper
(`device_cluster.py`)."""
