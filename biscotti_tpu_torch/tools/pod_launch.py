# The port's own copy of biscotti_tpu/tools/pod_launch.py; it imports nothing of biscotti_tpu.
# It launches the port's hive and peer CLIs and adds `--platform`, their torch device.
"""Multi-host fleet launcher — the reference's Azure run script as a
single tool (ref: azure/azure-run/runBiscotti.sh: keygen, build, generate
peersFileSent host:port list, ssh-launch nodesInEachVM processes per VM,
collect logs; azure-util/killall + get-all-LogFiles).

Targets a TPU pod or any ssh-reachable fleet: every host runs
`nodes_per_host` peer agents (hosts-as-peers mode; for the
peers-as-devices variant on a single host see
runtime/device_cluster.py). `localhost` entries execute directly
(subprocess), remote entries via ssh; --dry-run prints the exact
per-host commands without executing, for driving real fleets from an
orchestrator.

    python -m biscotti_tpu_torch.tools.pod_launch --hosts hosts.txt \
        --nodes-per-host 5 --dataset mnist --iterations 5 \
        [--key-dir keys/] [--dry-run]

After a local run, the chain-equality oracle is applied across every
peer's dump (ref: DistSys/localTest.sh:40-96) and a JSON summary printed.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys
import time

# THE layout helper (runtime/placement.py, stdlib-only import): the
# launcher, the supervisor, and the overlay contiguous-group assumption
# all consume hive_layout/aligned_overlay_group, so a resized host
# cannot silently break --overlay-group alignment
from biscotti_tpu_torch.runtime import placement

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_hosts(path: str):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]


def write_peers_file(hosts, nodes_per_host, base_port, out_path):
    """host:port per line, nodes_per_host consecutive ids per host
    (ref: peersFileSent in runBiscotti.sh) — the ranges come from the
    SHARED layout helper, not private arithmetic. Ports are
    base_port+global_id: distinct hosts don't collide anyway, and a
    localhost-only fleet (every 'host' the same machine) still gets
    unique ports."""
    layout = placement.hive_layout(0, len(hosts), per_host=nodes_per_host)
    with open(out_path, "w") as f:
        for h, (start, count) in zip(hosts, layout):
            addr = "127.0.0.1" if h == "localhost" else h
            for node_id in range(start, start + count):
                f.write(f"{addr}:{base_port + node_id}\n")


def committee_size(requested: int, total: int) -> int:
    """Clamp a committee size so small fleets keep vanilla WORKERS: the
    config's reference defaults (3 miners + 3 verifiers) would otherwise
    swallow every node of a 4-peer fleet — zero updates, all-empty
    blocks (the launcher's original silent failure mode). Large fleets
    (hive mode reaches N≥1000) pass through untouched below total//3."""
    return max(1, min(requested, total // 3))


def hive_cmd(args, start, count, total, peers_file, hive_id,
             bind_ip="127.0.0.1", overlay_group=0):
    """One HIVE process hosting `count` co-hosted peers (runtime/hive.py,
    --peers-per-host mode): the single-process-per-peer model tops out
    around N=400 on one box; a hive per host carries hundreds of
    lightweight peers on one device + loopback transport.
    `overlay_group` is the layout-aligned subtree size from
    `placement.aligned_overlay_group` (0: this host's own span — the
    uniform-layout value the two coincide on)."""
    cmd = [sys.executable, "-m", "biscotti_tpu_torch.runtime.hive",
           "-t", str(total),
           "-d", args.dataset, "-f", peers_file,
           "-a", bind_ip,
           "-p", str(args.base_port),
           "-sa", str(args.secure_agg), "-np", str(args.noising),
           "-vp", str(args.verification),
           "-na", str(committee_size(args.num_miners, total)),
           "-nv", str(committee_size(args.num_verifiers, total)),
           "-nn", str(committee_size(args.num_noisers, total)),
           "--iterations", str(args.iterations),
           "--seed", str(args.seed),
           "--local", f"{start}:{count}",
           "--hive-id", hive_id,
           "--platform", getattr(args, "platform", "cuda")]
    if getattr(args, "overlay", 0):
        # the aggregation subtree = this launcher's per-host span (or the
        # largest host-aligned divisor of an uneven layout), so the
        # tree's interior level never straddles a host (docs/OVERLAY.md)
        cmd += ["--overlay", "1",
                "--overlay-group", str(overlay_group or count)]
    if args.key_dir:
        cmd += ["--key-dir", args.key_dir]
    return cmd


def hive_summary(text):
    """The hive launcher's one-line JSON summary (last JSON line of its
    stdout), or None when the process died before printing it."""
    for line in reversed(text.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                continue
    return None


def cross_hive_equal(summaries):
    """THE cross-host chain-equality smoke check for hive mode: every
    hive's LOCAL chains must agree (chains_equal_local) AND every hive's
    anchor digest must match hive 0's — per-process output alone cannot
    see a cross-hive fork."""
    if not summaries or any(s is None for s in summaries):
        return False
    if not all(s.get("chains_equal_local") for s in summaries):
        return False
    ref = summaries[0].get("chain_digest")
    return bool(ref) and all(s.get("chain_digest") == ref
                             for s in summaries)


def placement_plan_from_args(args):
    """The supervisor's PlacementPlan from the CLI knobs — seeded, so a
    supervised run replays from its flags like a fault plan."""
    return placement.PlacementPlan(
        enabled=True,
        seed=args.placement_seed,
        interval=args.placement_interval,
        max_moves=args.placement_max_moves,
        rss_hot_bytes=args.placement_rss_hot,
        lag_hot_s=args.placement_lag_hot_s,
        shed_hot=args.placement_shed_hot,
        slow_hot=args.placement_slow_hot,
        min_hive_peers=args.placement_min_hive_peers)


def supervise(args, hosts) -> int:
    """Supervisor mode (--supervise; docs/PLACEMENT.md): the launcher
    itself becomes the placement controller. Each hosts-file row backs
    one hive (its own LoopbackHub + load readout) inside the
    supervisor's process, sized by the SAME `placement.hive_layout` the
    subprocess launcher uses; cross-hive traffic rides real TCP. At
    every decision point the controller reads the per-hive signals and
    live-migrates peers off hot hives — chain, breaker history,
    admission buckets and round position riding the migration ticket.
    All-localhost only: supervising remote hosts means scraping Metrics
    and draining over GetMigrationTicket, which needs a remote respawn
    channel this tool does not own."""
    import asyncio

    from biscotti_tpu_torch.config import BiscottiConfig, Defense
    from biscotti_tpu_torch.runtime.hive import LoopbackHub, rss_bytes
    from biscotti_tpu_torch.runtime.membership import surviving_prefix_oracle
    from biscotti_tpu_torch.runtime.peer import PeerAgent

    if any(h != "localhost" for h in hosts):
        print("[pod] --supervise drives hives in-process and needs an "
              "all-localhost hosts file", file=sys.stderr)
        return 2
    per = args.peers_per_host
    if not per:
        print("[pod] --supervise requires --peers-per-host (hive mode)",
              file=sys.stderr)
        return 2
    layout = placement.hive_layout(0, len(hosts), per_host=per)
    total = sum(c for _, c in layout)
    write_peers_file(hosts, per, args.base_port, args.peers_file)
    plan = placement_plan_from_args(args)
    cfg_base = BiscottiConfig(
        num_nodes=total, dataset=args.dataset,
        peers_file=args.peers_file, base_port=args.base_port,
        secure_agg=bool(args.secure_agg), noising=bool(args.noising),
        verification=bool(args.verification),
        num_miners=committee_size(args.num_miners, total),
        num_verifiers=committee_size(args.num_verifiers, total),
        num_noisers=committee_size(args.num_noisers, total),
        max_iterations=args.iterations, convergence_error=0.0,
        seed=args.seed, placement_plan=plan,
        overlay=bool(args.overlay),
        overlay_group=(placement.aligned_overlay_group(layout)
                       if args.overlay else 0))
    cfg_base = cfg_base.replace(timeouts=cfg_base.timeouts.scaled(
        cfg_base.num_nodes, cfg_base.num_verifiers, cfg_base.num_miners,
        random_sampling=cfg_base.random_sampling,
        defense_is_krum=cfg_base.defense == Defense.KRUM))

    hive_ids = [f"host{i}" for i in range(len(hosts))]
    hubs = {hid: LoopbackHub() for hid in hive_ids}
    infos = {hid: {"id": hid, "peers": count, "rss_bytes": 0,
                   "rss_peak_bytes": 0, "loop_lag_s": 0.0,
                   "rss_drift_bytes": 0, "loop_lag_drift_s": 0.0}
             for hid, (_, count) in zip(hive_ids, layout)}
    assignment = {node: hid
                  for hid, (start, count) in zip(hive_ids, layout)
                  for node in range(start, start + count)}

    def make_agent(node, hive_id, ticket):
        cfg = cfg_base.replace(node_id=node)
        a = PeerAgent(cfg, key_dir=args.key_dir, hive=hubs[hive_id],
                      ticket=ticket, device=args.platform)
        a.hive_info = infos[hive_id]
        return a

    ctl = placement.PlacementController(make_agent, assignment, plan)

    async def _monitor(period: float = 0.25) -> None:
        # one process hosts every hive, so RSS is a shared readout; the
        # per-hive differentiation comes from shed rates and straggler
        # profiles (placement.default_signals)
        loop = asyncio.get_running_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(period)
            lag = round(max(0.0, loop.time() - t0 - period), 4)
            rss = rss_bytes()
            for info in infos.values():
                info["loop_lag_s"] = lag
                info["rss_bytes"] = rss

    async def _run():
        mon = asyncio.get_running_loop().create_task(_monitor())
        try:
            return await ctl.run()
        finally:
            mon.cancel()

    t0 = time.time()
    results = asyncio.run(_run())
    wall = time.time() - t0
    equal, settled, real = surviving_prefix_oracle(results)
    summary = {
        "supervised": True, "total_nodes": total, "hosts": len(hosts),
        "hive_mode": True, "peers_per_host": per,
        "chains_equal": equal, "settled_height": settled,
        "real_blocks": real,
        "s_per_iter": round(wall / max(1, args.iterations), 3),
        "placement": ctl.summary(),
    }
    print(json.dumps(summary))
    return 0 if equal and real >= 1 else 1


def peer_cmd(args, node_id, total, peers_file, bind_ip="127.0.0.1"):
    cmd = [sys.executable, "-m", "biscotti_tpu_torch.runtime.peer",
           "-i", str(node_id), "-t", str(total),
           "-d", args.dataset, "-f", peers_file,
           "-a", bind_ip,  # remote hosts bind all interfaces (NAT'd fleets)
           "-p", str(args.base_port),
           "-sa", str(args.secure_agg), "-np", str(args.noising),
           "-vp", str(args.verification),
           "-na", str(committee_size(args.num_miners, total)),
           "-nv", str(committee_size(args.num_verifiers, total)),
           "-nn", str(committee_size(args.num_noisers, total)),
           "--max-iterations", str(args.iterations),
           "--seed", str(args.seed),
           "--platform", getattr(args, "platform", "cuda")]
    if getattr(args, "overlay", 0):
        per = args.peers_per_host or args.nodes_per_host
        layout = placement.hive_layout(0, 1, per_host=per)
        cmd += ["--overlay", "1",
                "--overlay-group",
                str(placement.aligned_overlay_group(layout))]
    if args.key_dir:
        cmd += ["--key-dir", args.key_dir]
    return cmd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", required=True,
                    help="file with one host per line; 'localhost' runs "
                         "in-place, anything else becomes an ssh command")
    ap.add_argument("--nodes-per-host", type=int, default=5)
    ap.add_argument("--peers-per-host", type=int, default=0,
                    help="hive mode: ONE process per host co-hosting this "
                         "many lightweight peers (runtime/hive.py) instead "
                         "of nodes-per-host full agent processes — the "
                         "single-box scale wall breaker (docs/HIVE.md)")
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--platform", default="cuda",
                    help="torch device of the launched peers and hives: "
                         "'cuda' or 'cpu'")
    ap.add_argument("--base-port", type=int, default=14350)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--secure-agg", type=int, default=0)
    ap.add_argument("--noising", type=int, default=0)
    ap.add_argument("--verification", type=int, default=1)
    ap.add_argument("--key-dir", default="")
    ap.add_argument("--overlay", type=int, default=0,
                    help="1 arms the hierarchical aggregation overlay on "
                         "every launched peer/hive, with the subtree "
                         "sized to the per-host span (docs/OVERLAY.md)")
    ap.add_argument("--num-miners", type=int, default=3)
    ap.add_argument("--num-verifiers", type=int, default=3)
    ap.add_argument("--num-noisers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--supervise", type=int, default=0,
                    help="1: run the elastic-fleet supervisor instead of "
                         "detached subprocesses — one in-process hive per "
                         "hosts-file row, a seeded placement controller "
                         "live-migrating peers off hot hives "
                         "(docs/PLACEMENT.md; all-localhost hive mode)")
    ap.add_argument("--placement-seed", type=int,
                    default=placement.PlacementPlan.seed)
    ap.add_argument("--placement-interval", type=int,
                    default=placement.PlacementPlan.interval,
                    help="anchor rounds between placement decisions")
    ap.add_argument("--placement-max-moves", type=int,
                    default=placement.PlacementPlan.max_moves)
    ap.add_argument("--placement-rss-hot", type=int,
                    default=placement.PlacementPlan.rss_hot_bytes)
    ap.add_argument("--placement-lag-hot-s", type=float,
                    default=placement.PlacementPlan.lag_hot_s)
    ap.add_argument("--placement-shed-hot", type=float,
                    default=placement.PlacementPlan.shed_hot)
    ap.add_argument("--placement-slow-hot", type=float,
                    default=placement.PlacementPlan.slow_hot)
    ap.add_argument("--placement-min-hive-peers", type=int,
                    default=placement.PlacementPlan.min_hive_peers)
    ap.add_argument("--peers-file", default="/tmp/biscotti_peers.txt")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--ssh-cmd", default="ssh",
                    help="remote-exec command (shlex-split); swap for "
                         "'python -m biscotti_tpu_torch.tools.sshim' to drive "
                         "the remote branch on a box with no ssh client")
    ap.add_argument("--scp-cmd", default="scp",
                    help="file-distribution command (shlex-split); pair "
                         "with --ssh-cmd's sshim: '... sshim --scp'")
    args = ap.parse_args(argv)

    hosts = read_hosts(args.hosts)
    if args.supervise:
        return supervise(args, hosts)
    per_host = args.peers_per_host or args.nodes_per_host
    layout = placement.hive_layout(0, len(hosts), per_host=per_host)
    total = sum(c for _, c in layout)
    aligned_group = placement.aligned_overlay_group(layout)
    write_peers_file(hosts, per_host, args.base_port,
                     args.peers_file)

    # distribute the bootstrap artifacts to every remote host (the
    # reference scp's peersFileSent + keys to each VM, runBiscotti.sh)
    remote_hosts = sorted({h for h in hosts if h != "localhost"})
    for h in remote_hosts:
        copies = [(args.peers_file, args.peers_file, [])]
        if args.key_dir:
            copies.append((args.key_dir, args.key_dir, ["-r"]))
        for src, dst, flags in copies:
            scp = [*shlex.split(args.scp_cmd), "-q", *flags, src,
                   f"{h}:{dst}"]
            if args.dry_run:
                print(f"[scp]   {' '.join(shlex.quote(c) for c in scp)}")
                continue
            rc = subprocess.run(scp).returncode
            if rc != 0:
                print(f"[pod] scp of {src} to {h} failed ({rc})",
                      file=sys.stderr)
                return 2

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    def launch(key, h, cmd):
        if h == "localhost":
            if args.dry_run:
                print(f"[local] {' '.join(map(shlex.quote, cmd))}")
                return
            procs.append((key, subprocess.Popen(
                cmd, cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True)))
        else:
            remote = (f"cd {shlex.quote(REPO)} && "
                      f"{' '.join(map(shlex.quote, cmd))}")
            ssh = [*shlex.split(args.ssh_cmd), h, remote]
            if args.dry_run:
                print(f"[ssh]   {' '.join(map(shlex.quote, ssh))}")
            else:
                procs.append((key, subprocess.Popen(
                    ssh, stdout=subprocess.PIPE,
                    stderr=subprocess.DEVNULL, text=True)))

    procs = []
    for hi, (h, (start, count)) in enumerate(zip(hosts, layout)):
        bind_ip = "127.0.0.1" if h == "localhost" else "0.0.0.0"
        if args.peers_per_host:
            # hive mode: one process per HOST, co-hosting its layout span
            launch(hi, h, hive_cmd(args, start, count, total,
                                   args.peers_file, f"hive{hi}", bind_ip,
                                   overlay_group=aligned_group))
        else:
            for node_id in range(start, start + count):
                launch(node_id, h, peer_cmd(args, node_id, total,
                                            args.peers_file, bind_ip))
    if args.dry_run:
        print(json.dumps({"dry_run": True, "total_nodes": total,
                          "hosts": len(hosts),
                          "hive_mode": bool(args.peers_per_host),
                          "peers_file": args.peers_file}))
        return 0

    deadline = time.time() + args.timeout
    outs = {}
    for nid, p in procs:
        budget = max(1.0, deadline - time.time())
        try:
            out, _ = p.communicate(timeout=budget)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs[nid] = out or ""

    if args.peers_per_host:
        # hive mode: every hive prints one JSON summary; the smoke check
        # is cross_hive_equal — local equality per hive AND one digest
        # across hives (a cross-hive fork is invisible per-process)
        summaries = [hive_summary(outs.get(hi, "")) for hi in
                     range(len(hosts))]
        equal = cross_hive_equal(summaries)
        ok = [s for s in summaries if s]
        summary = {
            "total_nodes": total, "hosts": len(hosts),
            "hive_mode": True, "peers_per_host": per_host,
            "overlay": bool(args.overlay),
            "chains_equal": equal,
            "blocks": ok[0].get("blocks", 0) if ok else 0,
            "s_per_iter": max((s.get("s_per_iter", 0.0) for s in ok),
                              default=None),
            # fleet-wide TCP-crossing bytes per round (summed over
            # hives): THE overlay headline, read off the artifact
            "cross_host_bytes_per_round": round(sum(
                s.get("cross_host_bytes_per_round", 0) for s in ok), 1),
            "loopback_avoided_bytes_per_round": round(sum(
                s.get("loopback_avoided_bytes_per_round", 0)
                for s in ok), 1),
            "rss_per_peer_bytes": max(
                (s.get("rss_per_peer_bytes", 0) for s in ok),
                default=None),
            "hives": ok,
        }
        print(json.dumps(summary))
        return 0 if equal else 1

    def chain_of(text):
        lines = text.splitlines()
        try:
            a = lines.index("=== CHAIN DUMP ===")
            b = lines.index("=== LOGS ===")
            return "\n".join(lines[a + 1: b])
        except ValueError:
            return ""

    chains = {nid: chain_of(t) for nid, t in outs.items()}
    ref = chains.get(0, "")
    equal = bool(ref) and all(c == ref for c in chains.values())
    summary = {
        "total_nodes": total, "hosts": len(hosts),
        "chains_equal": equal,
        "blocks": len(ref.splitlines()) - 1 if ref else 0,
    }
    print(json.dumps(summary))
    return 0 if equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
