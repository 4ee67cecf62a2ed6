# The port's own copy of biscotti_tpu/tools/keygen.py; it imports nothing of biscotti_tpu.
"""Bootstrap key generation — dealerless DKG genesis, dealer as legacy.

The reference's trusted dealer builds a commitment key of size = model dims
from a secret MSM ladder and per-node bn256 keypairs, writing
`commitKey.json`, `pKeyG1.json` and `peersfile.txt` for every node to read
at startup (ref: keyGeneration/generateBootstrapFile.go:26-120,
publicKey.go:26-61; consumed by DistSys/honest.go:760-871).

Two genesis modes:

* ``--genesis dkg`` (default) — the dealerless path (crypto/dkg.py,
  docs/PLACEMENT.md §Genesis DKG): an N-party Pedersen-verifiable
  ceremony where every party deals a Shamir-shared contribution under a
  commitment grid and verifies every other deal before accepting; the
  commitment-key label is derived from the ceremony transcript, so no
  single party — and no dealer — sits in the trust path. Artifacts stay
  format-compatible with the dealer's, plus ``genesis.json`` carrying
  the transcript, per-dealer grid digests, and each node's joint share.
* ``--genesis dealer`` — the LEGACY transparent-dealer path: one
  process derives the commitment key from a static label and hands out
  identity seeds. Kept only for compatibility and fast ephemeral test
  clusters; it prints a loud legacy warning.

Artifacts:

    commit_key.json   {"dims": d, "label": ..., "points": [hex, ...]}
    node_keys.json    {"<id>": {"schnorr_seed": hex, "vrf_roles_seed": hex,
                                "vrf_noise_seed": hex, "schnorr_pub": hex,
                                "vrf_roles_pub": hex, "vrf_noise_pub": hex}}
    peers.txt         host:port per line (ref: peersfile.txt shape)
    genesis.json      (dkg only) ceremony transcript + joint shares

Usage:  python -m biscotti_tpu_torch.tools.keygen --dims 7850 --nodes 100 \
            --out ./keys [--genesis dkg|dealer] [--host 127.0.0.1 \
            --base-port 8000]
"""

from __future__ import annotations

import argparse
import json
import os
import secrets

from biscotti_tpu_torch.crypto import ed25519 as ed
from biscotti_tpu_torch.crypto.commitments import CommitKey
from biscotti_tpu_torch.crypto.vrf import VRFKey


def _write_identity_and_peers(nodes: int, out_dir: str, host: str,
                              base_port: int) -> None:
    """Per-node identity seeds + the peers file — identical in both
    genesis modes (identities are always drawn locally per node; only
    the commitment-key trust path differs)."""
    node_keys = {}
    for i in range(nodes):
        schnorr_seed = secrets.token_bytes(32)
        roles_seed = secrets.token_bytes(32)
        noise_seed = secrets.token_bytes(32)
        node_keys[str(i)] = {
            "schnorr_seed": schnorr_seed.hex(),
            "vrf_roles_seed": roles_seed.hex(),
            "vrf_noise_seed": noise_seed.hex(),
            "schnorr_pub": ed.public_key(schnorr_seed).hex(),
            "vrf_roles_pub": VRFKey(roles_seed).public.hex(),
            "vrf_noise_pub": VRFKey(noise_seed).public.hex(),
        }
    with open(os.path.join(out_dir, "node_keys.json"), "w") as f:
        json.dump(node_keys, f, indent=1)

    with open(os.path.join(out_dir, "peers.txt"), "w") as f:
        for i in range(nodes):
            f.write(f"{host}:{base_port + i}\n")


def generate(dims: int, nodes: int, out_dir: str, host: str = "127.0.0.1",
             base_port: int = 8000, label: str = "biscotti-tpu-v1") -> None:
    """LEGACY dealer genesis: commitment key from a static label chosen
    by whoever runs this process. Kept for compatibility and ephemeral
    test clusters; `generate_dkg` is the trust-path replacement."""
    os.makedirs(out_dir, exist_ok=True)

    key = CommitKey.generate(dims, label.encode())
    with open(os.path.join(out_dir, "commit_key.json"), "w") as f:
        json.dump({"dims": dims, "label": label, "points": key.serialize()}, f)

    _write_identity_and_peers(nodes, out_dir, host, base_port)


def generate_dkg(dims: int, nodes: int, out_dir: str,
                 host: str = "127.0.0.1", base_port: int = 8000,
                 threshold: int = 0, rng_seed=None) -> dict:
    """Dealerless genesis via the in-process DKG ceremony (crypto/dkg.py):
    every node deals a Pedersen-committed contribution, verifies every
    other deal, and the commitment-key label comes from the ceremony
    transcript — no party picks it and no dealer ever exists. Returns
    the genesis record it wrote (tests assert on it directly)."""
    from biscotti_tpu_torch.crypto import dkg

    os.makedirs(out_dir, exist_ok=True)
    k = int(threshold) or max(2, min(dkg.DKG_CHUNKS, (nodes // 2) + 1))
    res = dkg.run_ceremony(nodes, k, rng_seed=rng_seed)
    label = res.label
    key = CommitKey.generate(dims, label.encode())
    with open(os.path.join(out_dir, "commit_key.json"), "w") as f:
        json.dump({"dims": dims, "label": label, "points": key.serialize()}, f)

    accepted = [d for d in res.deals
                if int(d.dealer_id) not in set(res.rejected)]
    genesis = {
        "genesis": "dkg",
        "parties": nodes,
        "threshold": k,
        "transcript": res.transcript.hex(),
        "label": label,
        "rejected_dealers": sorted(res.rejected),
        "deal_digests": {str(d.dealer_id): d.digest().hex()
                         for d in accepted},
        "shares": {str(s.party_id): {
            "x": s.x,
            "row": [int(v) for v in s.row],
            "blind_row": s.blind_row.tobytes().hex(),
        } for s in res.shares},
    }
    with open(os.path.join(out_dir, "genesis.json"), "w") as f:
        json.dump(genesis, f, indent=1)

    _write_identity_and_peers(nodes, out_dir, host, base_port)
    return genesis


def make_ephemeral_dir(dataset: str, nodes: int,
                       model_name: str = "") -> str:
    """Generate a dealer key dir in a fresh temp directory sized for this
    dataset's model dims — the shared bootstrap for eval harnesses
    (eval/scale_test.py --key-dir auto, eval/eval_committee_scale.py)."""
    import sys
    import tempfile

    from biscotti_tpu_torch.models.zoo import model_for_dataset

    dims = model_for_dataset(dataset, model_name or "").num_params
    out_dir = tempfile.mkdtemp(prefix="biscotti_keys_")
    print(f"[keygen] LEGACY dealer keys (ephemeral eval path): "
          f"dims={dims} nodes={nodes} -> {out_dir}", file=sys.stderr)
    generate(dims=dims, nodes=nodes, out_dir=out_dir)
    return out_dir


_commit_key_cache: dict = {}


def load_commit_key(out_dir: str) -> CommitKey:
    """Parse commit_key.json once per (path, mtime) and share the result:
    in-process clusters build one PeerAgent per node, and at d=7,850 a
    per-agent parse cost N× the startup time of the whole cluster. The
    key is immutable public data, so sharing the object is safe."""
    path = os.path.join(out_dir, "commit_key.json")
    stamp = (path, os.path.getmtime(path))
    cached = _commit_key_cache.get(stamp)
    if cached is not None:
        return cached
    with open(path) as f:
        data = json.load(f)
    key = CommitKey.deserialize(data["points"])
    _commit_key_cache.clear()  # at most one key per process lifetime
    _commit_key_cache[stamp] = key
    return key


def load_node_keys(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "node_keys.json")) as f:
        return json.load(f)


def load_peers(out_dir: str) -> list:
    with open(os.path.join(out_dir, "peers.txt")) as f:
        return [line.strip() for line in f if line.strip()]


def main(argv=None) -> int:
    import sys

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dims", type=int, required=True,
                    help="model parameter count (commit key size)")
    ap.add_argument("--nodes", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--base-port", type=int, default=8000)
    ap.add_argument("--genesis", choices=("dkg", "dealer"), default="dkg",
                    help="dkg: dealerless Pedersen-verifiable ceremony "
                         "(default); dealer: LEGACY trusted-label path")
    ap.add_argument("--dkg-threshold", type=int, default=0,
                    help="ceremony recovery threshold (0 = derive from "
                         "--nodes, capped for recovery cost)")
    ap.add_argument("--dkg-seed", type=int, default=None,
                    help="deterministic ceremony seed (replayable test "
                         "ceremonies; omit for OS randomness)")
    args = ap.parse_args(argv)
    if args.genesis == "dealer":
        print("[keygen] WARNING: --genesis dealer is the LEGACY "
              "trusted-dealer path; the dealerless default is "
              "--genesis dkg (docs/PLACEMENT.md)", file=sys.stderr)
        generate(args.dims, args.nodes, args.out, args.host, args.base_port)
        print(f"wrote commit_key.json, node_keys.json, peers.txt "
              f"to {args.out}")
    else:
        g = generate_dkg(args.dims, args.nodes, args.out, args.host,
                         args.base_port, threshold=args.dkg_threshold,
                         rng_seed=args.dkg_seed)
        print(f"wrote commit_key.json, node_keys.json, peers.txt, "
              f"genesis.json to {args.out} "
              f"(dkg transcript {g['transcript'][:16]}..., "
              f"threshold {g['threshold']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
