#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`biscotti_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port only (nothing of JAX or of `biscotti_tpu`), in phases, each
printed as one JSON line:

  1. device   card name and power limit (nvidia-smi), TF32 off for matmul
              and cuDNN;
  2. build    the three CUDA libraries (B1, B2, B3) built from the repo's
              sources by nvcc, one process each, started together, with
              ptxas's register and spill report, the on-curve kernel's SASS
              instruction mix, the Krum Gram kernel's (its FFMA and HMMA
              counts), each ladder kernel's (B3a-B3d) registers and spills
              of every template instance, and the ladder source's layout
              constants; no ladder kernel may spill;
  3. kernel   krum_scores kernel vs its plain PyTorch version on the card,
              random shapes up to (4096, 7850), a 30-row duplicate-tie case,
              a poison-cluster case whose accept set must be identical
              (rtol 1e-4 on scores) and a cancellation-heavy case (rows
              sharing one large mean) whose accept set must be identical
              and whose error against float64 scores must be no larger
              than the plain version's (10 % slack); the non-finite cases
              of ROADMAP C1 at (716, 7850) (a row whose squared norm
              overflows, +inf, −inf, a NaN input), B1 and the plain
              version on the card against the plain version on the CPU:
              accept sets equal, NaN bits and infinities equal, finite
              scores within rtol 1e-4; ROADMAP C2's x1e-20 rows at
              (716, 7850) (every product subnormal: B1 = plain = the
              reference's accept set, the n − f lowest ids, all scores
              0); at every shape two
              calls and a direct launch equal bit for bit; the wrapper's,
              the kernel's alone (the C interface on scratch allocated
              once), the plain version's and the fp32 cuBLAS Gram x @ x.T's
              times (CUDA events, median of 20) beside the card's least
              time for the work on the pipe the kernel uses and on the
              TF32 tensor pipe (the H100 SXM's published peaks);
  4. main     the simulator round at eval/eval_sim_scale.py's largest
              configuration (mnist softmax, N=1024, S=716, KRUM, DP ε=1,
              batch 10) with poison 0.3: 2 warm and 5 timed rounds, the
              kernel launched exactly once per round;
  5. parity   the kernel on the main path's own updates, its error held
              below half the Krum score gap at the accept boundary, its
              times as in phase 3 and two calls equal bit for bit; the
              same updates with one row's squared norm overflowing and
              rows of ±inf (C1), held as in phase 3, and scaled to a
              largest |x| of 1e-20 (C2, the reference's accept set);
              one round's draws
              run on the card and on the CPU port: masks and stakes
              equal, w within rtol 1e-4;
  crypto_kernel
              the on-curve kernel (B2) vs its plain PyTorch version on
              the VSS fold's 64 × 7,850 = 502,400 cells (valid points,
              bit flips, x + p, y + p, edge values, (0, −1), (0, 1),
              random limbs): masks exactly equal, the known-valid cells
              all True, a 20,000-cell sample held against the python-int
              oracle; the wrapper's, the kernel's alone and the plain
              version's times (CUDA events, median of 20) beside the
              card's least time for the work;
  crypto      the device crypto plane at the mnist secure-aggregation
              width (C = 785 chunks × k = 10 = 7,850 grid points, 35 grids
              a wave padded to 64), in VssIntakeBatch's order: validate
              and sum a wave with two bad grids (B2 launched once, exactly
              those two evicted), fold a second wave with ext_add, settle
              (msm == pedersen_commit_point, and not when one scalar
              changes); B3's launches over that intake (every kernel at
              least once) and over one more settle-width msm (B3a once,
              B3d at most twice for its 13-level tree, nothing else);
              card == CPU port bit for bit on a small wave; host-clock
              times of every entry point; B3a-B3d against their plain
              versions at the settle's shapes (the msm's 8,192 lanes, the
              fixed-base walk at 4 x 256 and the Pedersen comb at 1 x 512,
              the wave's 64 x 7,850 cells, verdicts alone as `grid_sum`
              runs B3c and with the points, ext_add's 7,850 pairs and the
              msm's tree) and `grid_sum` whole on the wave (its tree one
              B3d launch), bit for bit, each timed through its wrapper,
              alone and plain (CUDA events) beside its bound (the work of
              the field arithmetic of a double, an add and a wire cell,
              counted from field.py's and group.py's operations; no
              kernel's listing is read), its layout's occupancy bound and
              resident warps; one
              torch.profiler window over the msm (its kernel count
              recorded, not gated);
  secagg      the secure-aggregation plane at the bench's mnist_100_dp_eps1
              width (d = 7,850, C = 785, k = 10, 3 miners at r = 2: 21
              shares, 7 rows a miner), the native library loaded: one
              worker's quantize (from the card) → vss_commit_chunks →
              vss_blind_rows → make_shares, timed; 35 seeded workers, one
              grid with a single off-curve cell; miner 0's intake through
              VssIntakeBatch in two waves, armed on the card with
              BISCOTTI_PALLAS_CRYPTO=1 (B2 once a fold) and disarmed
              (native): the same sid evicted at the first fold, settle
              True on both, B3's launches at least 1 each armed and 0
              disarmed (prewarm's counted apart); a second batch with one corrupted share row
              settles False on both; recover_update of the honest
              workers' aggregated shares armed and disarmed equals Σq/10⁴
              exactly; every fold, settle and recovery timed (host clock
              after a synchronize), `prewarm` timed;
  models      each CNN family (mnist_cnn, cifar_cnn, lfw_cnn) from flat_init
              weights: parameter count, the forward pass and the
              simulator's per-contributor step (S = 8, batch 10) on the
              card against the CPU port within rtol 1e-4, the TF32
              switches of matmuls (where the convolutions run) and cuDNN
              as read inside the step (both must be off; the phase turns
              both on around it), whether two steps are bit-identical;
  defenses    one warm and 3 timed rounds of each defense (KRUM, MULTIKRUM,
              FOOLSGOLD, RONI, TRIMMED_MEAN without secure aggregation,
              NONE, ENSEMBLE) at the main configuration, B1 launched once a
              round under KRUM and MULTIKRUM and never otherwise, and one
              round's draws on the card and on the CPU port (masks and
              stakes equal, w within rtol 1e-4);
  cnn         the mnist CNN at the main configuration's scale (d = 164,266,
              S = 716): 2 warm and 5 timed rounds with B1 once a round at
              (716, 164266); B1 against its plain version on one round's
              noised updates from flat_init weights (accept sets equal,
              error below half the boundary gap or, where plain's own
              error against float64 exceeds it, no less exact than plain;
              times and bound as in phase 3); a device_trace window over 3
              rounds (device ms a round, idle share, top kernels);
  bench       the eight BASELINE rows through biscotti_tpu_torch.bench
              (device_round_s, the crypto-inclusive keys and the six wire
              and cross-host byte columns each, the share round-trip
              exact, the device settle on creditcard_10, the
              mnist_100_dp_eps1 headline), and one round of each CNN row
              on the card and on the CPU port from flat_init weights;
  trainer     the per-peer Trainer on the card against the CPU port (mnist
              softmax and mnist_cnn), one private_fun's time, and mcmc13
              Trainers at d = 7,850 and 164,266: acceptance rate, mean row
              norm against the law's 2d/ε (within 1 %), presample time;
  ledger      the ledger and wire plane on the card's own rounds: 3 rounds
              of the main configuration, each sealed into a Block (global_w
              on the f32 grid, the card's stakes, one secure-agg Update for
              each accepted contributor: an empty delta and the SHA-256 of its
              update as the commitment) and appended with consider_block to
              a 1,024-node Blockchain; one plain-mode block of 70 accepted
              mnist_cnn updates (d = 164,266, ~92 MB as float64) on a chain
              of its own; every block sent through the port's Pool to the
              port's RPCServer on 127.0.0.1 under raw64 and f32+zlib (4 MiB
              chunks), the server appending it to a second chain: dumps
              equal, verify() passes, every decoded hash the sealed one, a
              checkpoint save/load equal; frame bytes, codec ratios,
              chunk frames and the encode, send and decode seconds of each
              block kind (host clock), and the bench's six byte columns for
              the main configuration;
  live        in-process clusters of port PeerAgents on the card over
              loopback TCP (1 verifier, 1 miner, 1 noiser each round; the
              verifier's pool holds every other peer's update): (a) 7
              peers, mnist softmax (d = 7,850), KRUM + noising + secure
              aggregation on the native host crypto, 3 rounds; (b) 7
              peers, the same with device_crypto armed on the card, batch
              intake and BISCOTTI_PALLAS_CRYPTO=1 (B2 once a miner's
              fold), 3 rounds, B3a, B3c and B3d launched in the rounds
              beyond the peers' prewarms, and its witness: the same
              rounds on the native plane, whose chain (b)'s must equal
              hash for hash where every round pooled the same workers
              (a verifier pools the first 5 of 6 updates to arrive: up to
              LIVE_PAIRS runs of the pair, each row with its pools and
              each block's contributors); (c) 7 peers, mnist_cnn (d =
              164,266) in plain mode
              with KRUM verification, 2 rounds. Each: chains equal,
              rounds reached, non-empty blocks, each round's wall time,
              the peers' phase totals, every peer's Trainer on the card,
              the verifiers' pools and accept counts ((a) and (c): a pool
              of 5, so Krum scores on 1 neighbour and rejects 2 in a
              live block); (b) B2's launches. Then the verifier seam: an
              unstarted card peer and a CPU peer give the same KRUM,
              MULTIKRUM, FOOLSGOLD, RONI and ENSEMBLE masks on seeded
              12-row pools at d = 7,850 and on C2's x1e-20 rows. Then
              two armed Byzantine clusters, each beside a native-plane
              witness of the same classes and seed (the PeerAgent
              subclasses of `byzantine_peers`): (d) 7 peers, secure
              aggregation, noising and verification with no defense,
              pipelined rounds with speculation and batched intake, 3
              rounds, two of round 0's workers a CorruptSharePeer and a
              ForgedCommitmentPeer: honest chains equal, both offenders
              rejected, never accepted and debited, the accepted and
              rejected ids and the stake map the witness's (on equal
              pools, up to BYZANTINE_PAIRS pairs), speculation steps ready
              and none failed, B2 in the folds and B3a, B3c and B3d in
              the rounds; (e) the reference's colluding cancellation (7
              peers, 2 miners, one round): two colluders whose share
              offsets cancel in a miner's intake batch and a miner that
              lies one of them out of the agreed set; every intake
              verdict of the armed run equals the native plane's on the
              same instances (the cancelled batch passes), the
              aggregation-boundary re-check rejects and debits the
              remaining colluder, the lied-out one is not accepted and
              an honest update is;
  chaos       the chaos CLI, `biscotti_tpu_torch.tools.chaos.main([...,
              "--device", "cuda"])`, at the live width (mnist softmax, d =
              7,850), with BISCOTTI_PALLAS_CRYPTO=1 and the B2 and B3
              counters at 0 (`crypto_switch`), every agent it builds
              recorded (`PeerRecorder`, each one's Trainer on the card):
              (a) 7 peers, 3 rounds, secure aggregation, verification
              and the device plane armed, 5 % drops, half the frames
              delayed 0.05 s, peer 1 replaying each of its frames 20
              times, admission on: the honest peers' settled prefixes
              equal to a height of 2 with a real block, the flood
              fired, the honest peers shed, every inflight and parked
              peak within its cap, no breaker opened between honest
              peers but on failures of dropped frames (the call times
              out) or of calls to a peer that had ended its run and
              closed its server (`PeerRecorder` records each open's
              streak with the fault drawn for each attempt; a busy reply
              never counts), the plane on the device with B3a and B3d
              launched beyond the prewarms, B2's and B3c's launches
              reported (a one-shot intake folds no grid), the wall time
              within 60 s and two of the CLI's 75 s armed block windows
              (ROADMAP C12: the flooder's calls resolve on a shed
              replay's busy reply, so it fetches no block, waits out
              rounds 1 and 2 and mints empty ones); the CLI's own
              verdict, which the flooder's chain fails, is reported, not
              gated; (b) 5 peers,
              8 rounds, verification, churn 0.25 a period of 4 rounds, 2
              down, churn seed 14 (a JOIN, a KILL and a RESTART):
              rc 0 (the surviving-prefix oracle), the applied events a
              non-empty prefix of the schedule, a member join seen; (c)
              7 peers, 3 rounds, verification with 3 verifiers, the
              roleflood campaign on 30 % of the ids (the attack
              matrix's cell shape): rc 0, campaign actions, each logged
              flood target the miner committee that the anchor's chain
              re-derives, a defense verdict; (b) and (c) within 60 s
              each;
  protocol    the keyed and CNN-width secure-aggregation paths armed on
              the card, each beside a native-plane witness of the same
              settings and seed, paired as `live` (b) until a pair pooled
              alike (up to PROTOCOL_PAIRS): (a) 4 cifar_cnn peers at full
              width (d = 62,006), secure aggregation, verification, no
              defense, batch 4 (the reference's test_runtime.py:222),
              pipelined with batched intake, 2 rounds: the chain, the
              rejected ids and the stakes the witness's, B2 in the miners'
              folds and B3a, B3b, B3c and B3d launched in the rounds beyond
              the peers' prewarms (each peer's prewarm taken at this
              width); (b) 4 peers keyed by the dealerless genesis
              (`tools.keygen.generate_dkg`, d = 7,850), 2 rounds, the
              witness keyed from the same directory: nothing rejected,
              every accepted commitment 32 bytes, a commit key on every
              peer, the chain the witness's; before it, B3a on the msm of
              a keyed commitment over the transcript's generators and B3b
              on H's table, bit for bit against their plain versions, the
              device's commitment the native plane's; (c) the reference's
              codec acceptance (test_wire_codecs.py:346): 4 mnist_cnn peers
              (d = 164,266) with the Trainers on the card and the native
              crypto plane, 2 rounds under raw64 and under f32+zlib: each
              run's chains equal, no submission rejected, and the block
              gossip's bytes a round at least PROTOCOL_GOSSIP_X times
              fewer under f32+zlib. Then B2 and B3c at the cifar_cnn
              fold's cells, B3a and B3d's tree at (a)'s settle msm and B3b
              at (b)'s keyed Pedersen comb, the inputs the rounds gave
              them (`KernelInputs`), each against its plain version, timed
              through its wrapper, alone and plain, beside its bound;
  acceptance  the reference's slow acceptance drills (its tests marked
              `slow` that start a cluster), each as its test builds it
              (peers, roles, rounds, seeds, fault plans, windows, flags)
              and gated by its assertions, on the card and at the mnist
              softmax width (d = 7,850; the reference ran all but (d) on
              creditcard): (a) the device cluster's bit-identity guard
              (test_crypto_kernels.py:618): 5 peers, secure aggregation
              and verification, no defense, pipelined with batched
              intake, one round, a share corrupter (the highest id off
              round 0's committees), run on the native plane and then
              armed (`crypto_switch(arm=True)`), paired as `live` (b)
              until the two pooled alike (up to ACCEPT_GUARD_PAIRS): each
              run's honest chains equal and the two runs' chains, sorted
              `submission_rejected` evidence (id, source, reason) and
              stakes equal, the evidence not empty, the corrupter below
              its genesis stake, B2 and B3c in the armed run's grid folds
              and B3a, B3b and B3d in its settles (beyond the prewarms);
              (b) two port Hives of 50 (test_hive.py:353), 3 rounds,
              FaultPlan seed 23 (2 % drops, 10 % of frames delayed, 5 %
              churn every 2 rounds): 100 results, the surviving-prefix
              oracle equal with a settled block, faults injected,
              loopback RPCs, then one batch of the first hive's stepper
              (device ms) and the RSS a peer; (c), run only when named
              (`python3 chip_smoke.py acceptance c`: on the card round
              0, the settled prefix of its 2 rounds, mints empty under
              the reference's rules, the genesis announce of 100 peers
              on one event loop and a refused worker's decline counting
              as accounted, ROADMAP C16), the rebalance of
              test_placement.py:377: N = 100 on two hosts' LoopbackHubs
              through the PlacementController, secure aggregation,
              noising and verification, 20 % sampled, the reference's
              rigged host signals: the prefix equal with a real block, 2
              or more moves, each host0 -> host1, each moved peer
              migrated and restored, all 100 stakes at or above the
              default, and round 0's event times (`round_events`); (d)
              the slow fleet of test_stragglers.py:522: 10
              peers, the tee preset on the 2 the reference's seed scan
              picks, secure aggregation and verification, batch 10,
              adaptive deadlines (floor 1 s), 5 rounds: a real block in
              2 of a common prefix of 3, no breaker open toward and no
              debit of a tee peer, `tools.obs`'s merge with 2 slow and 10
              adaptive peers and a table with `stragglers:` and
              `waiting-on`; (e) the churn verdict of
              test_membership.py:658: 8 peers, 2 miners, 12 rounds, 30 %
              poisoners under FOOLSGOLD, churn seed 15 (20 % a period of
              6 rounds, 2 down) through a snapshot-bootstrapped
              ChurnRunner, then the plain run: both prefixes equal with a
              real block, half the rounds settled under churn, the
              schedule replayed, and the settled defense verdict
              (`tools.verdicts`) the plain run's; (f) the rolling upgrade
              of test_upgrade.py:116 through the chaos CLI (8 peers, 8
              rounds, from version 0, waves of 3 every 2 rounds, secure
              aggregation, f32+zlib): rc 0, waves at rounds 2, 4 and 6,
              7 upgrades applied, every final version the current one,
              the prefix equal with a real block. Each cell's line: its
              seconds, each round's wall time, the rounds reached, real
              blocks, the oracle's values and every kernel's launches;
  matrices    the reference's last slow drills and one cycle of the
              port's soak, each built as its test builds it at the mnist
              softmax width and gated by its assertions: (a) the chaos
              matrix of test_faults.py:521, 4 peers, 4 rounds, each of
              the FaultPlans drop20, delay100, dup30, reset15 and mixed
              (seed 29): the settled prefix equal over a common height of
              2 or more with a real block and a fault injected in every
              case, each case's wall time, RPC retries and breaker opens;
              (b) the mnist flood acceptance of test_admission.py:597, 4
              peers, node 1 flooding 50x under the TIGHT admission plan,
              then admission without the flood, then neither: the flood
              run's prefix equal over 2 or more with a real block, honest
              sheds, every inflight and parked peak under its cap and no
              breaker open between honest peers; the clean run without a
              shed or an open; both runs without the flood equal with a
              real block and final errors within 0.15; (c) the attack-
              matrix driver of test_adversary.py:636 through
              `eval.eval_attack_matrix.main` ({static, hug} x {NONE,
              KRUM}, 5 peers, 3 rounds, `--platform cuda`): rc 0, 4 rows
              with the test's columns, each row's failed bit its survival,
              the chaos CLI in its replay, no poisoned record accepted
              where a campaign survived, the JSON and CSV artifacts; (d)
              the traced overlay under chaos of test_tracing.py:532, armed
              (`crypto_switch(arm=True)`): 8 peers, secure aggregation,
              verification, 2 miners, the overlay in groups of 4,
              FaultPlan seed 11 (5 % drops, 20 % of frames delayed 50 ms),
              3 rounds, polled mid-run by `tools.trace_round.poll_cluster`
              (2 rounds, 240 s budget, every 0.5 s): every chain equal, a
              complete round over 3 or more peers whose critical path
              covers 2 or more peers and 80 % of its wall time and sums to
              it within 1e-3, the Chrome trace valid with X events, B3a,
              B3b and B3d in its rounds beyond the prewarms, the overlay's
              tallies reported; (e) `tools.soak.main`, one cycle of 6
              mnist peers for 8 rounds with the CLI's churn, roleflood
              campaign, stragglers, drops and SLO limits, one migration
              and a rolling upgrade from protocol row 0 (waves every 2
              rounds): the surviving-prefix oracle with a real block,
              every SLO gate but the RSS drift (ROADMAP C19: one cycle's
              RSS rise scaled to an hour fails it, in the reference's soak
              too), one cycle, schema soak-v1; the exit code, the five
              SLO values beside their limits and the RSS series
              reported. Every peer on the card.
              `python3 chip_smoke.py matrices [CELLS]` runs the phase
              alone;
  hive        co-hosted port peers on the card, one process, loopback
              transport, one batched SGD call a round (runtime/hive.py):
              (a) the reference's density entry at N = 100 (bench.py:452)
              through `bench.bench_peer_density`, a subprocess of `python -m
              biscotti_tpu_torch.runtime.hive -t 100 -d mnist --iterations
              2 -sa 0 -np 0 -vp 1 --seed 3` (d = 7,850): s/iter, peak RSS
              per peer, loop lag, stepper batches, chains equal; (b) a Hive
              of 100 mnist_cnn peers (d = 164,266), KRUM, 1 round, then one
              HiveStepper batch at the final weights: its draws' host ms,
              its time (CUDA events) and torch.profiler's device ms and
              kernel count, every peer's delta held to its standalone
              Trainer's on the card (rtol 1e-4); (c) a Hive of 528 mnist
              softmax peers, 1 verifier, 1 miner, 1 noiser, plain mode with
              KRUM, 1 round: the verifier's pool of 526 updates lies in
              B1's window, so B1 scores it inside the live round (its
              launch count must rise), then B1 on that pool against its
              plain version (accept sets equal, rtol 1e-4) and timed as in
              phase 3; (d) a single-device BatchStepper cluster of 8 mnist
              peers, 2 rounds. Each cell: chains equal, every round a
              non-empty block;
  drivers     the eval drivers and the reference bench's other entries
              on the card, each through its entry point: (a)
              `eval.eval_krum_kernel` at n = 128 .. 8192 (d = 7,850, the
              reference's inputs, f = n // 2), B1 through its wrapper at
              every n against the plain path (accept sets equal, rtol
              1e-4), the kernel alone, the wrapper, the plain path and the
              cuBLAS Gram timed and the bound; (b) `eval.eval_sim_scale` at
              N = 100, 256, 512, 1024 (mnist softmax, 5 rounds): s/iter,
              the scan's device ms and idle share, B1 once a round at
              N = 1024 (S = 716) and never below; (c) the bench's
              crypto-kernel entry at widths 8, 35, 100, the card's msm =
              the native one, B2's launches counted, B3a's and B3d's at
              least 1; (d) its migration
              entry at N = 100, 2 iterations (a move, chains equal); (e)
              one attack-matrix cell, hug × KRUM, at the matrix's operating
              point (mnist@dir0.3, 10 nodes, 3 verifiers, 8 rounds),
              chains equal; (f) one straggler row, 20 % slowed with
              adaptive deadlines, chains equal; (g) `eval.local_test`: 4
              processes of the port's peer CLI on the card, 2 iterations,
              dumps equal byte for byte;
  mesh        the multi-device paths on torch.distributed: (a) a
              one-rank NCCL group on the card, `make_sharded_round_step`
              at mnist softmax, N = 1,024 (every peer contributes), KRUM,
              DP ε = 1, batch 10, poison 0.3, a warm-up and 5 timed
              rounds, B1 once a round on the gathered pool of 1,024; the
              last round's mask the plain Krum path's on the same pool,
              w, mask and error the single-device Simulator's on the same
              draws (cidx = arange(N)) and, over a one-rank gloo group,
              the CPU port's (rtol 1e-5); host ms a round, the step and
              the draws alone, the all-gather's and psum's ms, device ms
              and idle share (torch.profiler), B1 alone, through its
              wrapper and plain at (1024, 7850); (b) the same at
              mnist_cnn width (d = 164,266), 3 rounds; (c)
              `dryrun_multichip(1)` on the card; (d) two ranks of a gloo
              group on the one card (NCCL takes one rank a GPU), the
              softmax rounds of (a), masks and w equal to (a)'s; no
              process group left set up. Each rank's Simulator holds only
              its own peers (`peers=local_slice(mesh, N)`): (a) and (b)
              report 1,024 peers held and the bytes of x and y, (d) each
              rank's 512 peers (a gate), bytes and
              `torch.cuda.max_memory_allocated`;
  entry       `multichip.entry()`, the counterpart of
              `__graft_entry__.py::entry`, on the card: its step on its
              arguments twice, bit-identical, and equal to the
              Simulator's `round_step(w, stake, 0)`; its host ms (median
              of 20, each ending in a synchronize); B1 launches 0 (S = 16
              lies below B1's window, as in the reference);
  6. kernels  one line for every ported kernel (B1's launches from phases
              4, defenses, cnn, ledger, acceptance and matrices (0: every
              pool under 512), hive (c), drivers (a) and (b) and mesh (a)
              and (b),
              with its times at (716, 164266), at the hive's live pool, at
              the mesh's gathered pools and at each committee size of
              drivers (a) beside those at (716, 7850); B2's from the
              crypto and secagg phases' intakes, the live miners' folds,
              chaos (a), protocol (a) and (b), acceptance (a), matrices (d)
              and drivers (c); B3a-B3d's from the crypto and secagg
              intakes, the rounds of live (b), (d) and (e), of chaos (a),
              of protocol (a) and (b), of acceptance (a), of matrices (d)
              and drivers (c), each with
              its times and bound
              at the settle's shape and, under `at`, the protocol
              phase's).

Then the card's `name, power.limit` line as nvidia-smi prints it (the line
the run's records are keyed by) and, last, the device JSON. Any
failed check raises, and the script exits non-zero without the last line;
with no CUDA device it exits 1 at once.

`python3 chip_smoke.py acceptance [CELLS]` and `python3 chip_smoke.py
matrices [CELLS]` build the libraries and run that phase alone, its
default cells or the letters named (then its launches and the nvidia-smi
line).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# B1's timing (CUDA events), bound and accept-set helpers live in the Krum
# kernel driver, which times B1 across committee sizes with the same code;
# the H100's published peaks come with them
from biscotti_tpu_torch.eval.eval_krum_kernel import (  # noqa: E402
    PEAK_BYTES_PER_S, PEAK_FP32_FLOPS, RTOL, accept_set, krum_times, rel_err,
    time_ms)
# the ladder library's layout constants, read from its source
from biscotti_tpu_torch.tools.ladder_ab import layout  # noqa: E402
# the integer pipes of one H100 SXM: 132 SMs at 1.98 GHz, the clock behind
# the data sheet's fp32 figure (67e12 / (132 SMs × 128 lanes × 2)); per SM
# and clock, 64 lanes of 32-bit integer results on each of the FMA pipe
# and the ALU pipe (CUDA C++ Programming Guide, arithmetic throughput
# table, compute capability 9.0) and 128 lanes issued (4 schedulers × 32)
SMS, CLOCK_HZ = 132, 1.98e9
PIPE_LANES, ISSUE_LANES = 64, 128
# SASS opcodes (the part before the first dot) by where they run; U* are the
# uniform datapath's, one per warp, and not counted either
FMA_PIPE = {"IMAD", "IMUL"}
ALU_PIPE = {"IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PLOP3", "IMNMX",
            "PRMT", "P2R", "R2P"}
EITHER_PIPE = {"VIADD"}
NOT_COUNTED = {"MOV", "LDC", "LDG", "STG", "LDL", "STL", "S2R", "CS2R", "EXIT",
               "BRA", "NOP", "HFMA2", "BSSY", "BSYNC"}
KERNEL_SHAPES = [(8, 16), (130, 50), (716, 7850), (1024, 7850), (4096, 7850)]
# kernel B3, the ladder library's four kernels (csrc/ed25519_ladder.cu): the
# wrapper of each, and the jitted program of the reference that it replaces
LADDER = {
    "B3a": ("msm_ladder_kernel", "msm_ladder",
            "biscotti_tpu/crypto/kernels/primitives.py:116"),
    "B3b": ("fixed_walk_kernel", "fixed_walk",
            "biscotti_tpu/crypto/kernels/primitives.py:134"),
    "B3c": ("grid_points_kernel", "grid_validate_points",
            "biscotti_tpu/crypto/kernels/primitives.py:155"),
    "B3d": ("point_add_kernel", "point_add",
            "biscotti_tpu/crypto/kernels/primitives.py:176")}
# The work of the ladders' field arithmetic on the integer pipes, counted
# from field.py's and group.py's operations and not from any kernel's
# listing, so that every bound of B3a-B3d measures the work whatever layout
# does it. A limb product is one IMAD.WIDE, two FMA-pipe passes: a field
# product takes 16 x 16 of them, a square 136 (each off-diagonal pair
# once, doubled). The fold 38 hi is one operation a limb on either pipe,
# once for each variable B factor (38 b is formed once an element; a
# constant's is free). On the ALU pipe a carry pass is two operations a
# limb (the mask and a shift-add), a product takes two passes, an add or a
# subtraction one operation a limb and a pass, a canonical form four
# passes and two conditional subtractions of p (two operations a limb
# each), a compare (with p, or of two forms) one operation a limb. These
# are the fewest instructions the arithmetic needs; the one-thread kernels'
# listings issue 1.4-2.1 times their FMA passes
# (tests/test_torch_ladder_bound.py).
FIELD_LIMBS = 16


def field_work(products=0, squares=0, folds=0, adds=0, canonicals=0,
               compares=0) -> dict:
    """Pipe counts ({fma, alu, either, issued}) of that much field
    arithmetic, as set out above."""
    n = FIELD_LIMBS
    wide = n * n * products + n * (n + 1) // 2 * squares
    passes = 2 * (products + squares) + adds + 4 * canonicals
    alu = n * (2 * passes + adds + 4 * canonicals + compares)
    either = n * folds
    return {"fma": 2 * wide, "alu": alu, "either": either,
            "issued": wide + alu + either}


# group.point_add: 9 products (c = (t1 2d) t2 is two; 2d a constant), the B
# factors y2 - x2, y2 + x2, t2, z2, then f, h, g; 9 adds and subtractions
POINT_ADD = field_work(products=9, folds=7, adds=9)
# group.point_double: 4 squares (x, y, z, x + y), 4 products (B factors f,
# h, g), 6 adds and subtractions
POINT_DOUBLE = field_work(products=4, squares=4, folds=7, adds=6)
# B3c's verdict of one wire cell: field.lt_p of x and y; group.on_curve's
# x^2, y^2, x^2 y^2 and d (x^2 y^2) (against 38 d), y^2 - x^2, 1 + d x^2
# y^2, the two canonical forms compared
CELL_VERDICT = field_work(products=2, squares=2, folds=3, adds=2,
                          canonicals=2, compares=3)
# the cell's point (x, y, 1, x y): one product, y's 38 y formed for y^2
CELL_POINT = field_work(products=1)
EXACT_SLACK = 1.1
# the VSS intake at the bench's mnist secure-aggregation width
# (bench.py:849-858: N = 100, sample_percent 0.70; config.py:170)
CHUNKS, POLY = 785, 10  # C chunks of k coefficients: d = 7,850
WAVE = 35  # num_samples // 2 grids a wave (bench.py:272)
SHARES = 15  # share points of the Shamir recovery timing
LEDGER_ROUNDS = 3  # of 5 until the acceptance phase needed the time
# S of the bench's mnist_cnn rows at N = 100 (bench.py:849-858): the
# accepted updates a plain-mode mnist_cnn block carries in the ledger phase
LEDGER_CNN_ROWS = 70
LEDGER_CODECS = ("raw64", "f32+zlib")
# peers of every live cluster: a verifier's pool of 5, Krum's least pool
# that scores on a neighbour (k = n - f - 2 = 1)
LIVE_PEERS = 7
LIVE_BASE_PORT = 17500
LIVE_PAIRS = 3  # runs of (b) and its witness, until they pool alike
# runs of (d) and its witness, until they pool alike: in (d)'s round 2 six
# workers arrive for a pool of 5, and two of the first four pairs run on
# the H100 pooled other workers there (ROADMAP C8)
BYZANTINE_PAIRS = 8
# a live cluster's round windows on the native host plane, and armed: the
# long windows cost nothing when no deadline is reached
LIVE_FAST = dict(update_s=20.0, block_s=60.0, krum_s=20.0, share_s=20.0,
                 rpc_s=20.0)
LIVE_ARMED = dict(update_s=120.0, block_s=300.0, krum_s=120.0, share_s=120.0,
                  rpc_s=120.0)
# the peers' counters a live row sums: the speculation plane's ledger and
# the miners' intake verdicts
LIVE_COUNTERS = ("speculation_ready", "speculation_hit",
                 "speculation_discard", "speculation_error",
                 "submission_rejected", "vss_batch_settled",
                 "intake_preverified", "secret_registered",
                 "update_rejected")
# the hive phase: (a) the reference's density entry at N = 100 (its CLI's
# default ports, 8000 + id), (b) 100 mnist_cnn peers, (c) N = 528, whose
# verifier pools 526 updates, inside B1's 512..4096 window, for one round
# (two until the drivers phase joined the script: each round is ~40 s of
# host time, and the script aims at half its 1200 s limit), (d) a
# single-device BatchStepper cluster
# chaos: the chaos CLI's cells at the live width (mnist softmax, d = 7,850)
CHAOS_BASE_PORT = 18700
CHAOS_CHURN_SEED = 14  # a JOIN, a KILL and a RESTART at 5 peers, 8 rounds
CHAOS_CELL_S = 60.0  # each cell's budget
# (a): the flooder's rounds 1 and 2 each wait out the CLI's armed block
# window (75 s) before their empty fallback block (ROADMAP C12), so its
# bound is the cell's budget and those two windows; a third stall fails.
# 2 rounds would not do: round 0's block is empty under the flood, and
# round 0 alone is the settled prefix of 2 rounds
CHAOS_A_STALLS = 2
CHAOS_A_FLAGS = [
    "--rounds", "3", "--secure-agg", "1", "--verification", "1",
    "--device-crypto", "1", "--fault-drop", "0.05", "--fault-delay", "0.5",
    "--fault-delay-s", "0.05", "--flood", "20", "--flood-node", "1",
    "--admission", "1"]
CHAOS_B_FLAGS = [
    "--rounds", "8", "--verification", "1", "--churn", "0.25",
    "--churn-period", "4", "--churn-down", "2", "--churn-seed",
    str(CHAOS_CHURN_SEED)]
CHAOS_C_FLAGS = [
    "--rounds", "3", "--verification", "1", "--verifiers", "3",
    "--campaign", "roleflood", "--campaign-attackers", "0.3"]
# protocol: (a) 4 cifar_cnn peers armed at full width (models/zoo.py's
# 62,006 parameters), (b) 4 peers keyed by the dealerless genesis at the
# mnist softmax width, each beside a native witness, 2 rounds, up to
# PROTOCOL_PAIRS pairs until a pair pooled alike (ROADMAP C8); (c) the
# reference's codec acceptance: 4 mnist_cnn peers under raw64 and under
# f32+zlib, the block gossip at least PROTOCOL_GOSSIP_X times smaller
PROTOCOL_BASE_PORT = 18800
PROTOCOL_PEERS = 4
PROTOCOL_ROUNDS = 2
PROTOCOL_PAIRS = 6
PROTOCOL_CNN_PARAMS = 62_006
PROTOCOL_KEYED_PARAMS = 7_850
PROTOCOL_KEY_SEED = 5  # generate_dkg's ceremony seed (test_dkg.py:248)
PROTOCOL_CODECS = ("raw64", "f32+zlib")
PROTOCOL_GOSSIP_X = 3.0  # test_wire_codecs.py:368
# acceptance: the reference's slow acceptance drills (ROADMAP C11, "The
# slow C11 rows" 2-7), each as its test builds it, on the card and at the
# mnist softmax width (the reference ran all but the slow fleet on
# creditcard): (a) the device cluster's bit-identity guard, armed, beside
# its native run until the two pooled alike (C8), (b) two hives of 50
# under drops and churn, (c) the rebalance at N = 100, (d) the slow
# fleet, (e) the churn verdict, (f) the rolling upgrade through the chaos
# CLI. Each drill's windows are its reference file's Timeouts; (c)'s go
# through Timeouts.scaled, which at N = 100 and one-member committees
# keeps them
ACCEPT_BASE_PORT = 20000
# the cells the phase runs: (c) stays out, since on the card its round 0
# mints empty under the reference's rules (ROADMAP C16); `python3
# chip_smoke.py acceptance c` runs it with its gates
ACCEPT_CELLS = "abdef"
ACCEPT_GUARD_PEERS = 5
ACCEPT_GUARD_PAIRS = 4
ACCEPT_HIVES_N = 100
ACCEPT_REBALANCE_N = 100
ACCEPT_FLEET_N = 10
ACCEPT_CHURN_N = 8
ACCEPT_CHURN_ROUNDS = 12
ACCEPT_WINDOWS = {
    "guard": dict(update_s=25.0, block_s=90.0, krum_s=20.0, share_s=25.0,
                  rpc_s=25.0),
    "two_hives": dict(update_s=8.0, block_s=40.0, krum_s=8.0, share_s=8.0,
                      rpc_s=10.0),
    "rebalance": dict(update_s=5.0, block_s=20.0, krum_s=4.0, share_s=5.0,
                      rpc_s=6.0),
    "slow_fleet": dict(update_s=20.0, block_s=45.0, krum_s=6.0,
                       share_s=20.0, rpc_s=8.0),
    "churn_verdict": dict(update_s=5.0, block_s=15.0, krum_s=3.0,
                          share_s=5.0, rpc_s=4.0),
    # the matrices phase's drills: test_faults.py:33, test_admission.py:36
    # and test_tracing.py:20
    "chaos_matrix": dict(update_s=4.0, block_s=12.0, krum_s=3.0,
                         share_s=4.0, rpc_s=4.0),
    "flood": dict(update_s=4.0, block_s=12.0, krum_s=3.0, share_s=4.0,
                  rpc_s=4.0),
    "trace_overlay": dict(update_s=20.0, block_s=60.0, krum_s=20.0,
                          share_s=20.0, rpc_s=10.0)}
ACCEPT_UPGRADE_FLAGS = [
    "--rounds", "8", "--rolling-upgrade", "0", "--upgrade-period", "2",
    "--upgrade-wave", "3", "--secure-agg", "1", "--codec", "f32+zlib"]
# matrices: the reference's last slow drills (ROADMAP C11, "The slow C11
# rows" 8), each as its test builds it at the mnist softmax width, and one
# cycle of the port's soak CLI: (a) the chaos matrix's five FaultPlans
# (test_faults.py:521), (b) the mnist flood acceptance's three runs
# (test_admission.py:597), (c) the attack-matrix driver
# (test_adversary.py:636), (d) the traced overlay under chaos, armed
# (test_tracing.py:532), (e) tools/soak.py's composed cycle
MATRIX_BASE_PORT = 22000
MATRIX_CELLS = "abcde"
MATRIX_CHAOS_SEED = 29
MATRIX_CHAOS_CASES = {
    "drop20": dict(drop=0.20), "delay100": dict(delay=1.0, delay_s=0.08),
    "dup30": dict(duplicate=0.30), "reset15": dict(reset=0.15),
    "mixed": dict(drop=0.10, delay=0.50, delay_s=0.05, duplicate=0.10,
                  reset=0.05)}
MATRIX_FLOOD_NODE = 1
MATRIX_FLOOD_X = 50
MATRIX_ERROR_GAP = 0.15  # the clean and baseline runs' final errors
MATRIX_ATTACK_ARGV = [
    "--quick", "--nodes", "5", "--rounds", "3", "--campaigns", "static,hug",
    "--defenses", "NONE,KRUM", "--dataset", "mnist", "--platform", "cuda",
    "--tag", "am_smoke"]
MATRIX_TRACE_PEERS = 8
MATRIX_TRACE_PLAN = dict(seed=11, drop=0.05, delay=0.2, delay_s=0.05)
MATRIX_TRACE_POLL = dict(rounds=2, budget_s=240.0, poll_s=0.5, min_nodes=3)
# the soak's defaults for churn, the campaign flood, stragglers, drops and
# every SLO limit; the rolling upgrade's waves every 2 rounds (2, 4, 6),
# since the CLI's default period of 3 puts the last of 6 peers' waves at
# round 9, past the cycle's 8 rounds, which the CLI refuses
SOAK_DRIFT_GATE = "rss_drift_bytes_per_h"  # ROADMAP C19
MATRIX_SOAK_ARGV = [
    "--minutes", "0", "--nodes", "6", "--rounds", "8", "--dataset", "mnist",
    "--device", "cuda", "--migrations-per-cycle", "1", "--rolling-upgrade",
    "0", "--upgrade-period", "2"]
HIVE_DENSITY_N = 100
HIVE_CNN_N = 100
HIVE_CNN_ROUNDS = 1  # of 2 until the acceptance phase needed the time
HIVE_POOL_N = 528
HIVE_POOL_ROUNDS = 1
HIVE_CLUSTER_N = 8
HIVE_BASE_PORT = 18000
# the drivers phase: (a) eval_krum_kernel's committee sizes at mnist
# softmax's d, the reference's default four (512..4096) and one more
# octave each side of B1's window; (b) eval_sim_scale's default sizes,
# whose N = 1024 (S = 716) alone lies in the window; (c) the crypto
# entry's widths (bench.py:520); (d)-(f) live clusters on the bench
# entries' own ports, below the ephemeral range (an outbound socket of an
# earlier cluster in this process squatted 19110 on the card), (g) from
# DRIVERS_LOCAL_PORT
DRIVER_KRUM_SIZES = (128, 256, 512, 1024, 2048, 4096, 8192)
DRIVER_KRUM_D = 7850
DRIVER_SIM_SIZES = (100, 256, 512, 1024)
DRIVER_SIM_ROUNDS = 5  # of 10 until the acceptance phase needed the time
DRIVER_MSM_WIDTHS = (8, 35, 100)
DRIVER_MIGRATION_N = 100
DRIVER_LOCAL_PEERS = 4
DRIVERS_LOCAL_PORT = 14600
# mesh: the sharded paths on a torch.distributed group (slice 9)
MESH_N = 1024
MESH_CELLS = (("softmax", "", 5), ("cnn", "mnist_cnn", 3))  # timed rounds
MESH_PROFILE_ROUNDS = 2
MESH_RTOL = 1e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def pipe_counts(mix) -> dict:
    """{fma, alu, either, issued}: what one thread's run through a SASS
    listing (`mix`, {opcode: count}, as `_build.sass_mix` reads it from the
    library this run built) puts on the integer pipes:
      * fma: the FMA pipe's lane-passes, IMAD and IMUL, each IMAD.WIDE (a
        limb product with a 64-bit result) counted twice for its two
        passes; IMAD.MOV is a move;
      * alu: the ALU pipe's adds, logic, shifts, LEA, compares and selects;
      * either: VIADD, which may go to either pipe;
      * issued: every counted instruction once;
      * unknown: {opcode: count} of what no pipe set names (counted as
        issued only, which can only lower a bound).
    Moves, loads, stores (local memory too), the uniform datapath and
    control instructions are not counted."""
    if not isinstance(mix, dict):
        raise AssertionError(f"pipe_counts needs the kernel's SASS mix: {mix}")
    fma = alu = either = issued = 0
    unknown: dict = {}
    for op, count in mix.items():
        base = op.split(".")[0]
        if base in NOT_COUNTED or base.startswith("U") \
                or op.startswith("IMAD.MOV"):
            continue
        if base in FMA_PIPE:
            fma += 2 * count if op.startswith("IMAD.WIDE") else count
        elif base in ALU_PIPE:
            alu += count
        elif base in EITHER_PIPE:
            either += count
        else:  # an issue slot at least, and named in the counts
            unknown[op] = count
        issued += count
    return {"fma": fma, "alu": alu, "either": either, "issued": issued,
            "unknown": unknown}


def pipe_clocks(c: dict) -> float:
    """SM clocks for work of pipe counts `c`: the pipes run at once, so
    max(fma / 64, alu / 64, issued / 128) lanes a clock, with VIADD placed
    where it gives the least time, so the bound holds wherever it runs."""
    e = c["either"]
    return min(max((c["fma"] + f) / PIPE_LANES,
                   (c["alu"] + e - f) / PIPE_LANES,
                   c["issued"] / ISSUE_LANES) for f in (0, e))


def oncurve_bound(n: int, mix):
    """(ms, what bounds it, the counts): the least time for the on-curve
    mask of n cells, the larger of the bytes (each cell's 32 int64 limbs
    read once, its 1-byte verdict written once) over the memory rate and
    the cell's integer instructions (`pipe_counts` of the kernel's own
    SASS mix) over the rate of the pipes that run them. The kernel has no
    loop and no data-dependent branch, so every cell issues the whole
    listing once."""
    if isinstance(mix, dict) and mix.get("BRA", 0) > 1:
        raise AssertionError("the on-curve kernel's SASS has a branch besides "
                             "its final one: the per-cell count needs its "
                             "trip count")
    c = pipe_counts(mix)
    clocks = pipe_clocks(c)
    ops_ms = 1e3 * n * clocks / (SMS * CLOCK_HZ)
    bytes_ms = 1e3 * n * (2 * 16 * 8 + 1) / PEAK_BYTES_PER_S
    counts = {**c, "sm_clocks_per_cell": clocks, "ops_ms": ops_ms,
              "bytes_ms": bytes_ms}
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", counts
    return bytes_ms, "bytes", counts


PIPES = ("fma", "alu", "either", "issued")


def scaled(c: dict, k) -> dict:
    return {key: k * c[key] for key in PIPES}


def summed(*cs: dict) -> dict:
    return {key: sum(c[key] for c in cs) for key in PIPES}


def ladder_bound(work: dict, nbytes: int, warp_threads=None,
                 warps: int = 0) -> dict:
    """The least time for a ladder kernel's work: the larger of `work`
    (pipe counts summed over every thread this run's data needs) over the
    card's integer pipes and `nbytes` (each input read once, each output
    written once) over its memory rate. With `warp_threads` (the pipe
    counts of the busiest warp's threads: a warp issues every step that any
    of its lanes needs) and `warps`, also the occupancy bound: one warp
    keeps one of an SM's four schedulers, which issues a warp instruction a
    clock and puts 16 lanes a clock through each pipe, and a scheduler runs
    ceil(warps / (4 SMs)) warps in turn."""
    ops_ms = 1e3 * pipe_clocks(work) / (SMS * CLOCK_HZ)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    out = {"bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_counts": work}
    if warp_threads is not None:
        per_sched = -(-warps // (4 * SMS))
        clocks = 4 * pipe_clocks(scaled(warp_threads, 32))
        out["occupancy_bound_ms"] = 1e3 * clocks * per_sched / CLOCK_HZ
        out["warps_per_scheduler"] = per_sched
    return out


def warp_set_steps(bits: np.ndarray, lanes: int) -> np.ndarray:
    """[m, words] packed bits → the number of steps each warp of `lanes`
    lanes (the last one may be partial) takes the add: steps where any of
    its lanes has its bit set."""
    words = bits.view(np.uint32)
    lanes = min(len(words), lanes)
    pad = -len(words) % lanes
    if pad:
        words = np.concatenate([words, np.zeros((pad, words.shape[1]),
                                                words.dtype)])
    w = words.reshape(-1, lanes, words.shape[1])
    union = np.bitwise_or.reduce(w, axis=1)  # [warps, words]
    return np.unpackbits(union.view(np.uint8), axis=1).sum(axis=1)


def msm_ladder_bound(bits: np.ndarray, nbytes: int, layout: dict) -> dict:
    """B3a's bound for `bits` ([m, words] packed) and `nbytes`: 32 words
    doubles a lane and one add a set bit (POINT_DOUBLE, POINT_ADD), and the
    occupancy bound of the source's layout (`layout`: G = kMsmGroup threads
    a lane, so ceil(m G / 32) warps of 32 / G lanes), each thread doing
    1/G of its lane's work."""
    m, steps, g = len(bits), 32 * bits.shape[1], layout["kMsmGroup"]
    pop = int(np.unpackbits(bits.view(np.uint8)).sum())
    busiest = int(warp_set_steps(bits, 32 // g).max())
    lane = summed(scaled(POINT_DOUBLE, steps), scaled(POINT_ADD, busiest))
    return ladder_bound(summed(scaled(POINT_DOUBLE, steps * m),
                               scaled(POINT_ADD, pop)),
                        nbytes, scaled(lane, 1 / g), -(-m * g // 32))


def fixed_walk_bound(bits: np.ndarray, nbytes: int, layout: dict) -> dict:
    """B3b's bound for `bits` ([m, words] packed) and `nbytes`: one add a
    set bit (POINT_ADD), and the occupancy bound of the source's layout
    (one lane a block of 4 kWalkGroup threads, ceil(4 G / 32) warps a
    lane), each thread doing 1/(4 G) of its lane's adds."""
    threads = 4 * layout["kWalkGroup"]
    per_lane = np.unpackbits(bits.view(np.uint8), axis=1).sum(axis=1)
    return ladder_bound(scaled(POINT_ADD, int(per_lane.sum())), nbytes,
                        scaled(POINT_ADD, int(per_lane.max()) / threads),
                        len(bits) * -(-threads // 32))


def ptxas_of(report: dict, kernel: str) -> dict:
    """ptxas's report of `kernel` over its template instances (every entry
    function whose name holds it): the most registers and spill bytes of
    any, and each instance's own under `instances`."""
    found = {name: r for name, r in report.items() if kernel in name}
    if not found:
        return {}
    worst = {key: max(r.get(key, 0) for r in found.values())
             for key in ("registers", "spill_stores", "spill_loads")}
    return {**worst, "instances": found}


def point_add_bound(n: int, nbytes: int, layout: dict) -> dict:
    """B3d's bound for n pairs: one add a pair (POINT_ADD), and the
    occupancy bound of the source's layout (kAddGroup threads a pair,
    ceil(n G / 32) warps), each thread doing 1/G of its add."""
    g = layout["kAddGroup"]
    return ladder_bound(scaled(POINT_ADD, n), nbytes, scaled(POINT_ADD, 1 / g),
                        -(-n * g // 32))


def tree_bound(rows: int, cols: int, nbytes: int, layout: dict) -> dict:
    """B3d's bound for the column sums of a [rows, cols] batch: (rows - 1)
    adds a column (POINT_ADD), and the occupancy bound of
    `cuda_ladder.tree_plan`'s launches summed (each launch's warps, its
    busiest group making its class's adds and one a level among the
    groups: a column of r members on q = min(kTreeGroups, r / 2) groups
    takes r / q - 1 + log2 q adds there, 1/G of each a thread)."""
    from biscotti_tpu_torch.crypto.kernels.cuda_ladder import tree_plan

    g, groups = layout["kAddGroup"], layout["kTreeGroups"]
    plan = tree_plan(rows, cols, groups)
    out = ladder_bound(scaled(POINT_ADD, (rows - 1) * cols), nbytes)
    occupancy, per_sched = 0.0, 0
    for r, c in plan:
        q = max(1, min(groups, r // 2))
        blocks = -(-c // (groups // q))
        adds = r // q - 1 + (q.bit_length() - 1)
        one = ladder_bound(POINT_ADD, 0, scaled(POINT_ADD, adds / g),
                           blocks * groups * g // 32)
        occupancy += one["occupancy_bound_ms"]
        per_sched = max(per_sched, one["warps_per_scheduler"])
    out["occupancy_bound_ms"] = occupancy
    out["warps_per_scheduler"] = per_sched
    out["launches"] = len(plan)
    return out


def grid_cell_bound(cells: int, points: bool) -> dict:
    """B3c's bound for `cells` wire cells: each cell's verdict
    (CELL_VERDICT) and, with `points`, its point (CELL_POINT), against its
    32 limbs read and its verdict (and its 64-limb point) written once;
    and the occupancy bound of one thread a cell (ceil(cells / 32)
    warps)."""
    cell = summed(CELL_VERDICT, CELL_POINT) if points else CELL_VERDICT
    nbytes = cells * (2 * 16 * 8 + 1 + (4 * 16 * 8 if points else 0))
    return ladder_bound(scaled(cell, cells), nbytes, cell, -(-cells // 32))


def grid_sum_bound(w: int, n: int, valid: int) -> dict:
    """`grid_sum`'s bound at [w, n] with `valid` valid grids: every cell's
    verdict (CELL_VERDICT), the valid grids' points (CELL_POINT) and
    valid - 1 adds a column (an invalid grid's identity needs none),
    against the cells read once, the grid verdicts and the n sums written
    once."""
    return ladder_bound(summed(scaled(CELL_VERDICT, w * n),
                               scaled(CELL_POINT, valid * n),
                               scaled(POINT_ADD, max(valid - 1, 0) * n)),
                        w * n * 2 * 16 * 8 + w + n * 4 * 16 * 8)


def resident_warps(registers, threads: int, smem: int):
    """Warps a scheduler that an SM holds of a kernel with `registers` a
    thread, `threads` a block and `smem` bytes of shared memory a block:
    65,536 registers (allocated 8 a thread at a time, a warp's at once),
    228 KB of shared memory (1 KB a block kept by the card), at most 32
    blocks and 64 warps an SM, four schedulers. None if registers are not
    known."""
    if not isinstance(registers, int):
        return None
    warps = -(-threads // 32)
    regs = -(-registers // 8) * 8
    blocks = min(65536 // (regs * 32 * warps), 32, 64 // warps,
                 (228 * 1024) // (smem + 1024) if smem else 32)
    return blocks * warps / 4


def krum_scores_fp64(x, num_adversaries: int):
    """Krum scores of x computed in float64 throughout: the yardstick of
    how exact the kernel and the plain version are."""
    import torch

    n = x.shape[0]
    k = n - num_adversaries - 2
    xd = x.double()
    sq = (xd * xd).sum(dim=-1)
    d = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (xd @ xd.T), min=0.0)
    d.fill_diagonal_(float("inf"))
    return torch.sort(d, dim=-1).values[:, :k].sum(dim=-1)


def boundary_rel_gap(ref, keep: int) -> float:
    """The relative gap of the plain scores at the accept boundary."""
    import torch

    s = torch.sort(ref).values
    return float((s[keep] - s[keep - 1]) / s[keep])


def nonfinite_case(case: str, x, num_adversaries: int) -> dict:
    """B1 and the plain version on the card against the plain version on
    the CPU for the same input x (on the card), the oracle the CPU tests
    hold to the reference: accept sets equal, the same NaN bits and
    infinities at the same places, finite scores within RTOL. Launches
    made here are comparisons, not main-path launches."""
    import torch

    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.ops.krum import same_nonfinite

    n, f = x.shape[0], num_adversaries
    oracle = krum_cuda.krum_scores_plain(x.cpu(), f)
    want = accept_set(oracle, n - f)
    fin = torch.isfinite(oracle)
    row = {"case": case, "n": n, "d": x.shape[1],
           "oracle_nan": int(torch.isnan(oracle).sum()),
           "oracle_inf": int(torch.isinf(oracle).sum())}
    for name, fn in (("kernel", krum_cuda.krum_scores_kernel),
                     ("plain_on_card", krum_cuda.krum_scores_plain)):
        got = fn(x, f)
        torch.cuda.synchronize()
        got = got.cpu()
        row[name] = {"accept_set_equal": accept_set(got, n - f) == want,
                     "nonfinite_equal": same_nonfinite(got, oracle),
                     "finite_max_rel_err": rel_err(got[fin], oracle[fin])}
    if not all(row[k]["accept_set_equal"] and row[k]["nonfinite_equal"]
               and row[k]["finite_max_rel_err"] < RTOL
               for k in ("kernel", "plain_on_card")):
        raise AssertionError(f"Krum on non-finite rows differs from the CPU "
                             f"oracle: {row}")
    return row


def host_s(fn, reps: int = 3):
    """(median host-clock seconds of `reps` calls, the last result). Every
    entry point of the crypto plane ends in a host copy of its result, so
    the clock covers its device work."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def valid_grid(seed: int):
    """One valid VSS commitment grid of C·k affine points aᵢ·B + bᵢ·H,
    with known aᵢ, bᵢ < q, from the port's fixed_base_mult on the card and
    its ed25519 copy for the affine form: ([C, k, 64] uint8, a, b)."""
    from biscotti_tpu_torch.crypto import ed25519 as ed
    from biscotti_tpu_torch.crypto.commitments import H_POINT
    from biscotti_tpu_torch.crypto.kernels import primitives as prim
    from biscotti_tpu_torch.crypto.kernels.cells import grid_bytes

    rng = np.random.default_rng(seed)
    n = CHUNKS * POLY
    a = [int.from_bytes(rng.bytes(32), "little") % ed.Q for _ in range(n)]
    b = [int.from_bytes(rng.bytes(32), "little") % ed.Q for _ in range(n)]
    grid = grid_bytes(a, b, prim.fixed_base_mult)
    for i in (0, 1, n - 1):  # the python-int oracle on a few points
        want = ed.to_affine(ed.point_add(ed.base_mult(a[i]),
                                         ed.scalar_mult(b[i], H_POINT)))
        got = (int.from_bytes(grid[i, :32].tobytes(), "little"),
               int.from_bytes(grid[i, 32:].tobytes(), "little"))
        if got != want:
            raise AssertionError(f"fixed_base_mult disagrees with the "
                                 f"oracle at point {i}")
    return grid.reshape(CHUNKS, POLY, 64), a, b


def oncurve_cells(grid_limbs: np.ndarray, waves: int, seed: int):
    """The VSS fold's cells with every kind of input mixed in: `waves`
    copies of the grid's [n, 2, 16] limbs, half left valid and half split
    among bit flips, x + p, y + p (on the curve, not canonical), edge
    values in either coordinate, the order-2 point (0, −1), the identity
    (0, 1) and random limbs. Returns (cells, {kind: indices}) for the
    kinds whose every cell lies on the curve."""
    from biscotti_tpu_torch.crypto import ed25519 as ed
    from biscotti_tpu_torch.crypto.kernels.cells import EDGE_FIELD, raw_limbs

    rng = np.random.default_rng(seed)
    cells = np.tile(grid_limbs.astype(np.int64), (waves, 1, 1))
    n = len(cells)
    order = rng.permutation(n)
    flip, xp, yp, edge, small, rand = np.array_split(order[:n // 2], 6)
    k = len(flip)
    cells[flip, rng.integers(0, 2, k), rng.integers(0, 16, k)] ^= \
        1 << rng.integers(0, 16, k)
    p_limbs = raw_limbs([ed.P])[0]
    for idx, coord in ((xp, 0), (yp, 1)):
        v, c = cells[idx, coord], 0
        for i in range(16):  # + p with the carry propagated: < 2²⁵⁶
            s = v[:, i] + p_limbs[i] + c
            v[:, i], c = s & 0xFFFF, s >> 16
        cells[idx, coord] = v
    edges = raw_limbs(EDGE_FIELD)
    k = len(edge)
    cells[edge, rng.integers(0, 2, k)] = edges[rng.integers(0, len(edges), k)]
    half = len(small) // 2
    cells[small[:half]] = raw_limbs([0, ed.P - 1])
    cells[small[half:]] = raw_limbs([0, 1])
    cells[rand] = rng.integers(0, 1 << 16, (len(rand), 2, 16))
    return cells, {"valid": order[n // 2:], "x_plus_p": xp, "y_plus_p": yp,
                   "order_2": small[:half], "identity": small[half:]}


def crypto_kernel_phase(dev, grid: np.ndarray, mix) -> dict:
    """Kernel B2 against its plain version on the VSS fold's cells; `mix`
    is its SASS mix from the build phase, for its bound."""
    import torch

    from biscotti_tpu_torch import _build
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv
    from biscotti_tpu_torch.crypto.kernels import group as gp
    from biscotti_tpu_torch.crypto.kernels import primitives as prim

    t_phase = time.perf_counter()
    waves = prim._pow2(WAVE, prim.GRID_MIN_WAVES)
    cells, valid_kinds = oncurve_cells(
        gp.xy_bytes_to_limbs(grid.tobytes(), CHUNKS * POLY), waves, seed=0)
    n = len(cells)
    xy = torch.from_numpy(cells).to(dev)
    launches = cv.oncurve_mask.launches
    got, ref = cv.oncurve_mask(xy), cv.oncurve_mask_plain(xy)
    torch.cuda.synchronize()
    mask = got.cpu().numpy()
    sample = np.random.default_rng(1).choice(n, min(n, 20_000), replace=False)
    canon, full = prim._cell_canonical_mask(cells[sample][None])
    try:
        ones = torch.ones(2, 2, dtype=torch.int64, device=dev)
        int64_matmul = f"runs: {(ones @ ones).tolist()}"
    except RuntimeError as e:
        int64_matmul = str(e).splitlines()[0]
    row = {"cells": n, "waves": waves,
           "mismatches": int((got != ref).sum()),
           "max_abs_err": float((got.int() - ref.int()).abs().max()),
           "on_curve": int(mask.sum()),
           "valid_kinds_all_true": {k: bool(mask[i].all())
                                    for k, i in valid_kinds.items()},
           "oracle_sample_agrees": bool(np.array_equal(mask[sample] & canon[0],
                                                       full[0])),
           "int64_matmul_on_card": int64_matmul,
           "ms": time_ms(lambda: cv.oncurve_mask(xy)),
           "plain_ms": time_ms(lambda: cv.oncurve_mask_plain(xy))}
    row["launches"] = cv.oncurve_mask.launches - launches  # 1 + timing
    # the kernel alone, without the wrapper's flag fill and read-back
    lib, stream = _build.load("oncurve"), torch.cuda.current_stream().cuda_stream
    out = torch.empty(n, dtype=torch.bool, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    row["kernel_only_ms"] = time_ms(lambda: lib.oncurve_mask_i64(
        xy.data_ptr(), out.data_ptr(), flag.data_ptr(), n, stream))
    if not torch.equal(out, got) or int(flag):
        raise AssertionError("the on-curve kernel's direct launch disagrees "
                             "with its wrapper")
    row["bound_ms"], row["bound_by"], row["bound_counts"] = oncurve_bound(n, mix)
    row["seconds"] = time.perf_counter() - t_phase
    emit("crypto_kernel", **row)
    if row["mismatches"]:
        raise AssertionError(f"on-curve kernel disagrees with its plain "
                             f"version on {row['mismatches']} cells")
    if not all(row["valid_kinds_all_true"].values()):
        raise AssertionError("on-curve mask is False on a cell that lies on "
                             "the curve")
    if not row["oracle_sample_agrees"]:
        raise AssertionError("on-curve kernel disagrees with the python-int "
                             "oracle")
    return row


def once_ms(fn) -> float:
    """The device time of one call (CUDA events), for a plain ladder whose
    call at a shape of the protocol phase takes seconds."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def ladder_record(rows: dict, phase: str, ladder: dict, flag, kid: str,
                  shape, got, want, wrapper, alone, plain_ms, bound: dict,
                  report=None) -> dict:
    """One row of a ladder kernel against its plain version: the outputs
    `got` and `want` equal element for element, the wrapper's and the
    kernel's alone times (CUDA events, median of 20), `plain_ms()`'s, the
    ptxas report (`report`, else the kernel's) and `bound`; emitted under
    `phase` and kept in `rows[kid]`. Raises if they differ or the kernel
    flagged a limb of its inputs."""
    import torch

    torch.cuda.synchronize()
    mism = sum(int((g != w).sum()) for g, w in zip(got, want))
    err = max(float((g.long() - w.long()).abs().max()) for g, w
              in zip(got, want))
    if report is None:
        report = ladder["ptxas"][kid]
    r = {"kernel": kid, "shape": shape, "mismatches": mism,
         "max_abs_err": err, "ms": time_ms(wrapper),
         "kernel_only_ms": time_ms(alone), "plain_ms": plain_ms(),
         "registers": report.get("registers"),
         "spill_stores": report.get("spill_stores"),
         **bound}
    if int(flag):
        raise AssertionError(f"{kid} flagged a limb of its own inputs")
    emit(phase, **r)
    rows.setdefault(kid, []).append(r)
    if mism:
        raise AssertionError(f"{kid} differs from its plain version at "
                             f"{shape} in {mism} places")
    return r


def ladder_rows(dev, ladder: dict, wave1, gam, acc, summed1, summed2,
                fixed_scalars, pedersen_ab) -> dict:
    """Kernels B3a-B3d against their plain versions on the card at the
    settle's full-width shapes (the msm's 8,192 lanes, the fixed-base walk
    at 4 x 256 and the Pedersen comb at 1 x 512, the wave's 64 x 7,850
    cells, ext_add's 7,850 pairs and the msm's 13-level tree), bit for
    bit; each timed through its wrapper, alone (the C interface on outputs
    allocated once) and plain (CUDA events, median of 20; the plain
    ladders, ~1e5 launches a call, median of 3), beside its bound.
    `ladder` is the build phase's ptxas reports (registers, spills) and
    the source's layout constants. Every bound counts the field
    arithmetic's work (POINT_ADD, POINT_DOUBLE, CELL_VERDICT, CELL_POINT),
    the occupancy bounds the layout's warps. B3c's first row is the
    instance the main path runs (`grid_sum`'s verdicts alone), its second
    the one with the points (`grid_validate_points`). Launches made here
    are comparisons, not main-path launches. Returns {id: [rows]}."""
    import torch

    from biscotti_tpu_torch import _build
    from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
    from biscotti_tpu_torch.crypto.kernels import group as gp
    from biscotti_tpu_torch.crypto.kernels import primitives as prim
    lib = _build.load("ed25519_ladder")
    stream = torch.cuda.current_stream().cuda_stream
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    rows: dict = {}

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def record(kid, shape, got, want, wrapper, alone, plain, bound,
               plain_reps=20, report=None):
        ladder_record(rows, "crypto", ladder, flag, kid, shape, got, want,
                      wrapper, alone, lambda: time_ms(plain, reps=plain_reps),
                      bound, report)

    # B3a: the settle's msm lanes
    bits_np, pts_np = prim.msm_lanes(gam, acc)
    m, words = bits_np.shape
    bits, pts = on(bits_np), on(pts_np)
    out = torch.empty_like(pts)
    lanes = cl.msm_ladder(bits, pts)
    record("B3a", [m, 4 * words * 8], (lanes,),
           (cl.msm_ladder_plain(bits, pts),),
           lambda: cl.msm_ladder(bits, pts),
           lambda: lib.ed25519_msm_ladder(bits.data_ptr(), words,
                                          pts.data_ptr(), out.data_ptr(),
                                          flag.data_ptr(), m, stream),
           lambda: cl.msm_ladder_plain(bits, pts),
           {**msm_ladder_bound(bits_np, bits.nbytes + 2 * pts.nbytes,
                               ladder["layout"]),
            "threads_a_lane": ladder["layout"]["kMsmGroup"],
            "threads_a_block": ladder["layout"]["kMsmThreads"]},
           plain_reps=3)

    # B3b: fixed_base_mult's 4 lanes and the Pedersen comb's one
    for bits_np, table_np in ((prim.fixed_lanes(fixed_scalars[:4]),
                               prim._fixed_table("B")),
                              (prim.pedersen_lanes(*pedersen_ab),
                               np.concatenate([prim._fixed_table("B"),
                                               prim._fixed_table("H")]))):
        m, words = bits_np.shape
        bits, table = on(bits_np), on(table_np)
        out = torch.empty((m, 4, 16), dtype=torch.int64, device=dev)
        record("B3b", [m, 32 * words], (cl.fixed_walk(bits, table),),
               (cl.fixed_walk_plain(bits, table),),
               lambda: cl.fixed_walk(bits, table),
               lambda: lib.ed25519_fixed_walk(bits.data_ptr(), words,
                                              table.data_ptr(), out.data_ptr(),
                                              flag.data_ptr(), m, stream),
               lambda: cl.fixed_walk_plain(bits, table),
               {**fixed_walk_bound(bits_np,
                                   bits.nbytes + table.nbytes + out.nbytes,
                                   ladder["layout"]),
                "threads_a_lane": 4 * ladder["layout"]["kWalkGroup"],
                "threads_a_block": 4 * ladder["layout"]["kWalkGroup"]},
               plain_reps=3)

    # B3c: the first wave's cells, two bad grids among them; the verdicts
    # alone (grid_sum's instance), then with the points
    xy = on(prim.wave_cells(wave1)).long()
    w, ncol = xy.shape[:2]
    cells = w * ncol
    ok = torch.empty((w, ncol), dtype=torch.bool, device=dev)
    gpts = torch.empty((w, ncol, 4, 16), dtype=torch.int64, device=dev)
    lay = ladder["layout"]
    for points in (False, True):
        report = ladder["ptxas"]["B3c"].get("instances", {})
        report = next((r for name, r in report.items()
                       if f"ILb{int(points)}E" in name), {})
        if points:
            got, want = (cl.grid_validate_points(xy),
                         cl.grid_points_plain(xy))
            wrapped = lambda: cl.grid_validate_points(xy)  # noqa: E731
            plain = lambda: cl.grid_points_plain(xy)  # noqa: E731
        else:
            got, want = (cl.grid_verdicts(xy),), (cl.grid_verdicts_plain(xy),)
            wrapped = lambda: cl.grid_verdicts(xy)  # noqa: E731
            plain = lambda: cl.grid_verdicts_plain(xy)  # noqa: E731
        record("B3c", [w, ncol] + (["points"] if points else []), got, want,
               wrapped,
               lambda p=points: lib.ed25519_grid_points(
                   xy.data_ptr(), ok.data_ptr(),
                   gpts.data_ptr() if p else None, flag.data_ptr(), cells,
                   stream),
               plain,
               {**grid_cell_bound(cells, points),
                "threads_a_cell": 1, "threads_a_block": lay["kCellThreads"],
                "resident_warps_a_scheduler": resident_warps(
                    report.get("registers"), lay["kCellThreads"],
                    lay["kCellThreads"] * (32 + 1) * 16 if points else 0)},
               report=report)

    # B3d: ext_add's pairs, then the msm's whole tree
    add_smem = 1344  # sizeof(AddSmem), one a group
    s1, s2 = on(summed1), on(summed2)
    n = len(s1)
    out = torch.empty_like(s1)
    g = lay["kAddGroup"]
    record("B3d", [n, 4, 16], (cl.point_add(s1, s2),),
           (cl.point_add_plain(s1, s2),),
           lambda: cl.point_add(s1, s2),
           lambda: lib.ed25519_point_add(s1.data_ptr(), s2.data_ptr(),
                                         out.data_ptr(), flag.data_ptr(), n,
                                         stream),
           lambda: cl.point_add_plain(s1, s2),
           {**point_add_bound(n, 3 * s1.nbytes, lay),
            "threads_a_lane": g, "threads_a_block": lay["kAddThreads"],
            "resident_warps_a_scheduler": resident_warps(
                ladder["ptxas"]["B3d"].get("registers"), lay["kAddThreads"],
                lay["kAddThreads"] // g * add_smem)})

    groups = lib.ed25519_tree_groups()

    def tree_alone(src, rows, cols, grid_ok=None):
        return cl.tree_launches(lib, src, rows, cols, flag, stream, grid_ok)

    m = len(lanes)
    tree_threads = groups * g
    record("B3d", ["tree", m], (cl.tree_sum(lanes),),
           (cl.column_tree_plain(lanes),),
           lambda: cl.tree_sum(lanes), lambda: tree_alone(lanes, m, 1),
           lambda: cl.column_tree_plain(lanes),
           {**tree_bound(m, 1, (m + 1) * 4 * 16 * 8, lay),
            "threads_a_lane": g, "threads_a_block": tree_threads,
            "resident_warps_a_scheduler": resident_warps(
                ladder["ptxas"]["B3d"].get("registers"), tree_threads,
                groups * add_smem)}, plain_reps=3)

    # grid_sum whole on the same wave: B3c's verdicts, the mask, the tree
    # (one launch at 64 waves) against the plain path on the card
    def plain_grid_sum():
        pok, ppts = cl.grid_points_plain(xy)
        pgrid = pok.all(dim=1)
        ppts[~pgrid] = gp.identity_on((), dev)
        return pgrid, cl.column_tree_plain(ppts)

    before = cl.point_add.launches
    got = cl.grid_sum(xy)
    grid_tree_launches = cl.point_add.launches - before
    grid_ok = got[0]
    record("grid_sum", [w, ncol], got, plain_grid_sum(),
           lambda: cl.grid_sum(xy),
           lambda: (lib.ed25519_grid_points(xy.data_ptr(), ok.data_ptr(),
                                            None, flag.data_ptr(), cells,
                                            stream),
                    tree_alone(xy, w, ncol, ok.all(dim=1))),
           plain_grid_sum,
           {**grid_sum_bound(w, ncol, int(grid_ok.sum())),
            "tree_launches": grid_tree_launches,
            "grid_ok": grid_ok.tolist()}, plain_reps=3, report={})
    if grid_tree_launches != 1:
        raise AssertionError(f"grid_sum's tree took {grid_tree_launches} B3d "
                             f"launches over {w} waves, not one")
    return rows


@contextlib.contextmanager
def crypto_switch(arm: bool = False):
    """BISCOTTI_PALLAS_CRYPTO=1 (kernel B2 in every grid validation) with
    the B2 and B3 launch counters and the plane's call counters at 0;
    `arm` also arms the device plane on the card (peers arm it from their
    configs). On exit the switch is off and the plane disarmed."""
    from biscotti_tpu_torch.crypto import kernels
    from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv

    os.environ["BISCOTTI_PALLAS_CRYPTO"] = "1"
    kernels.reset_counters()
    cv.oncurve_mask.launches = 0
    cl.reset_launches()
    try:
        if arm:
            kernels.set_enabled(True)
        yield
    finally:
        kernels.set_enabled(False)
        os.environ.pop("BISCOTTI_PALLAS_CRYPTO", None)


def crypto_phase(dev, grid: np.ndarray, a, b, ladder: dict) -> dict:
    """The device crypto plane in VssIntakeBatch's order at full width,
    then card vs CPU, times and a profile of the settle's msm."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from biscotti_tpu_torch.crypto import ed25519 as ed
    from biscotti_tpu_torch.crypto.commitments import _xy_to_point
    from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv
    from biscotti_tpu_torch.crypto.kernels import group as gp
    from biscotti_tpu_torch.crypto.kernels import primitives as prim

    t_phase = time.perf_counter()
    n = CHUNKS * POLY
    i_flip, i_nc = n // 5, 4 * n // 5  # one bad cell in each bad grid
    flip = grid.reshape(n, 64).copy()
    flip[i_flip, 0] ^= 1  # low bit of the cell's x: off the curve
    noncanon = grid.reshape(n, 64).copy()
    x = int.from_bytes(noncanon[i_nc, :32].tobytes(), "little")
    noncanon[i_nc, :32] = np.frombuffer((x + ed.P).to_bytes(32, "little"),
                                        np.uint8)
    if _xy_to_point(flip[i_flip].tobytes()) is not None \
            or _xy_to_point(noncanon[i_nc].tobytes()) is not None:
        raise AssertionError("the bad cells pass the CPU loader")
    bad = (5, 20)
    wave1 = [grid] * WAVE
    wave1[bad[0]], wave1[bad[1]] = flip, noncanon
    wave2 = [grid] * WAVE
    rng = np.random.default_rng(2)
    # RLC-shaped settle scalars: 8·v mod q, as VssIntakeBatch.verify forms
    gam = [(8 * int.from_bytes(rng.bytes(32), "little")) % ed.Q
           for _ in range(n)]

    # the intake, launches counted from 0: two wave folds and the settle
    with crypto_switch():
        t0 = time.perf_counter()
        mask1, summed1 = prim.grid_validate_sum(wave1)
        wave1_launches = cv.oncurve_mask.launches
        mask2, summed2 = prim.grid_validate_sum(wave2)
        acc = prim.ext_add(summed1, summed2)
        m = int(mask1.sum()) + int(mask2.sum())
        rhs = prim.msm(gam, acc)
        comb = (m * sum(g * s for g, s in zip(gam, a)),
                m * sum(g * s for g, s in zip(gam, b)))
        lhs = prim.pedersen_commit_point(*comb)
        settled = ed.point_equal(lhs, rhs)
        intake_s = time.perf_counter() - t0
        launches = cv.oncurve_mask.launches
        gam_bad = list(gam)
        gam_bad[17] = (gam_bad[17] + 1) % ed.Q
        perturbed = ed.point_equal(lhs, prim.msm(gam_bad, acc))
        b3_launches = cl.launches()  # the folds, the settle, the perturbed one
        # one settle-width msm: one ladder launch and the tree's two
        cl.reset_launches()
        prim.msm(gam, acc)
        msm_launches = cl.launches()

        # card against the CPU port on a small wave (the switch still on)
        ns = min(64, n)
        small = grid.reshape(n, 64)[:ns].copy()
        small_bad = small.copy()
        small_bad[ns // 2, 40] ^= 2  # a bit of one cell's y
        wave_s = [small, small_bad, small]
        gm, gs = prim.grid_validate_sum(wave_s)
        cmask, cs = prim.grid_validate_sum(wave_s, device="cpu")
        ga, ca = prim.ext_add(gs, gs), prim.ext_add(cs, cs, device="cpu")
        parity = {"mask_equal": bool(np.array_equal(gm, cmask)),
                  "summed_equal": bool(np.array_equal(gs, cs)),
                  "ext_add_equal": bool(np.array_equal(ga, ca)),
                  "msm_equal": prim.msm(gam[:ns], ga) == prim.msm(gam[:ns], ca,
                                                                   device="cpu"),
                  "mask": gm.tolist()}

    # times (host clock, median of 3; each call ends in a host copy)
    times = {}
    times["fold_switch_off_s"] = host_s(lambda: prim.grid_validate_sum(wave2))[0]
    with crypto_switch():
        times["fold_switch_on_s"] = host_s(
            lambda: prim.grid_validate_sum(wave2))[0]
    xy2 = np.stack([gp.xy_bytes_to_limbs(g.tobytes(), n) for g in wave2])
    times["host_oracle_s"] = host_s(lambda: prim._cell_canonical_mask(xy2))[0]
    times["fold_switch_on_minus_oracle_s"] = (times["fold_switch_on_s"]
                                              - times["host_oracle_s"])
    times["ext_add_s"] = host_s(lambda: prim.ext_add(summed1, summed2))[0]
    times["msm_s"] = host_s(lambda: prim.msm(gam, acc))[0]
    times["pedersen_commit_point_s"] = host_s(
        lambda: prim.pedersen_commit_point(gam[0], gam[1]))[0]
    times["fixed_base_mult_s"] = host_s(lambda: prim.fixed_base_mult(a, "B"))[0]
    xs = np.arange(SHARES) - 10  # share points as ss.share_xs makes them
    vander = xs[:, None] ** np.arange(POLY)[None, :]
    pinv = np.linalg.pinv(vander.astype(np.float64))
    coeffs = rng.integers(-10**4, 10**4, (CHUNKS, POLY))
    times["shamir_recover_s"], recovered = host_s(
        lambda: prim.shamir_recover(pinv, vander @ coeffs.T))

    # B3a-B3d against their plain versions at these shapes, timed
    ladder_kernels = ladder_rows(dev, ladder, wave1, gam, acc, summed1,
                                 summed2, a, comb)

    # one profiled msm: the ladder's device time and launches (late
    # profiler windows have dropped ctypes-launched kernels before:
    # recorded, not gated)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prim.msm(gam, acc)
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:5]
    msm_profile = {
        "device_ms": device_ms,
        "kernel_launches": sum(e.count for e in on_device),
        "device_idle_share": 1.0 - device_ms / (1e3 * times["msm_s"]),
        "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in top]}

    row = {"points": n, "wave": WAVE, "padded_waves":
           prim._pow2(WAVE, prim.GRID_MIN_WAVES), "msm_lanes":
           prim._pow2(n, prim.MSM_MIN_LANES),
           "wave1_mask_false": [int(i) for i in np.flatnonzero(~mask1)],
           "wave2_all_true": bool(mask2.all()), "valid_members": m,
           "oncurve_launches": launches, "wave1_launches": wave1_launches,
           "b3_launches": b3_launches, "settle_msm_launches": msm_launches,
           "settled": settled, "perturbed_settles": perturbed,
           "intake_s": intake_s, "card_vs_cpu": parity,
           "shamir_exact": bool(np.array_equal(recovered, coeffs)),
           "times": times, "msm_profile": msm_profile,
           "seconds": time.perf_counter() - t_phase}
    emit("crypto", **row)
    row["ladder"] = ladder_kernels  # emitted row by row above
    if row["wave1_mask_false"] != list(bad) or not row["wave2_all_true"]:
        raise AssertionError("grid validation evicted the wrong grids")
    if wave1_launches != 1 or launches != 2:
        raise AssertionError(f"the on-curve kernel launched {wave1_launches} "
                             f"times in the first fold and {launches} in the "
                             "intake, not once per fold")
    if not settled or perturbed:
        raise AssertionError("the settle does not hold the RLC equation")
    if {k: v for k, v in msm_launches.items() if k != "point_add"} \
            != {"msm_ladder": 1, "fixed_walk": 0, "grid_validate_points": 0} \
            or not 1 <= msm_launches["point_add"] <= 2:
        raise AssertionError(f"a settle-width msm launched {msm_launches}, "
                             "not B3a once and B3d at most twice")
    if min(b3_launches.values()) < 1:
        raise AssertionError(f"the intake did not launch every B3 kernel: "
                             f"{b3_launches}")
    if not all(v for k, v in parity.items() if k != "mask") \
            or parity["mask"] != [True, False, True]:
        raise AssertionError("card and CPU port disagree on the crypto plane")
    if not row["shamir_exact"]:
        raise AssertionError("shamir_recover is not exact")
    return row


def _settled_intake(members, waves, xs, rows, ent):
    """One miner intake through `VssIntakeBatch`: add each wave's members,
    fold it, then settle. Returns (rejected sids a fold, B2 launches a
    fold, settle, members, seconds a fold, settle seconds). Host clock
    after a synchronize."""
    import torch

    from biscotti_tpu_torch.crypto import commitments as cm
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv

    acc = cm.VssIntakeBatch(rows, CHUNKS, POLY, entropy=ent)
    rejected, per_fold, fold_s = [], [], []
    for wave in waves:
        for sid in wave:
            if not acc.add(sid, *members[sid]):
                raise AssertionError(f"intake refused worker {sid} at add")
        before = cv.oncurve_mask.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rejected.append(acc.fold())
        torch.cuda.synchronize()
        fold_s.append(time.perf_counter() - t0)
        per_fold.append(cv.oncurve_mask.launches - before)
    t0 = time.perf_counter()
    settled = acc.verify(xs)
    torch.cuda.synchronize()
    settle_s = time.perf_counter() - t0
    return (rejected, per_fold, settled, sorted(acc.members()), fold_s,
            settle_s)


def secagg_phase(dev) -> dict:
    """The secure-aggregation plane at the bench's mnist_100_dp_eps1 width
    (d = 7,850, C = 785, k = 10, N = 100, S = 70) with the reference
    protocol's r = 2 layout (3 miners, 21 shares, 7 rows a miner): one
    worker's quantize → commitments → blind rows → shares (timed), 35
    seeded workers (one grid with a single off-curve cell), miner 0's
    intake through VssIntakeBatch in two waves with the plane armed on the
    card (B2 on, once a fold) and disarmed (native), a second batch with a
    corrupted share row, and recovery armed and disarmed."""
    from dataclasses import replace

    import torch

    from biscotti_tpu_torch import bench
    from biscotti_tpu_torch.crypto import _native
    from biscotti_tpu_torch.crypto import commitments as cm
    from biscotti_tpu_torch.crypto import kernels
    from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv
    from biscotti_tpu_torch.ops import secretshare as ss

    t_phase = time.perf_counter()
    if not _native.available():
        raise AssertionError(f"native EC library did not load: "
                             f"{_native.load_error()}")
    cfg = replace(bench.config("mnist_100_dp_eps1"), share_redundancy=2.0)
    d, k, total = CHUNKS * POLY, cfg.poly_size, cfg.total_shares
    sl = ss.miner_rows(total, 0, cfg.num_miners)
    rows = sl.stop - sl.start
    xs_all = [int(x) for x in ss.share_xs(total)]
    rng = np.random.default_rng(5)
    updates = rng.normal(0.0, 0.01, (WAVE, d)).astype(np.float32)

    def worker(sid: int, update):
        q = ss.quantize(update)
        comms, blinds = cm.vss_commit_chunks(
            ss.to_chunks(q, k), bytes([sid]) * 32, b"secagg-round")
        return q, comms, cm.vss_blind_rows(blinds, xs_all), \
            ss.make_shares(q, k, total)

    # the others first: worker 0 is timed with the native comb tables warm
    rest = [worker(sid, updates[sid]) for sid in range(1, WAVE)]
    card_update = torch.from_numpy(updates[0]).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    made = [worker(0, card_update)] + rest
    worker_s = time.perf_counter() - t0
    bad_sid, cell = 11, (CHUNKS // 2, 3)
    made[bad_sid][1][cell][0] ^= 1  # low bit of one cell's x: off the curve
    if cm._xy_to_point(made[bad_sid][1][cell].tobytes()) is not None:
        raise AssertionError("the flipped cell is still on the curve")
    members = {sid: (c, sh[sl], br[sl]) for sid, (_, c, br, sh)
               in enumerate(made)}
    honest = [sid for sid in range(WAVE) if sid != bad_sid]
    waves = [list(range(WAVE // 2 + 1)), list(range(WAVE // 2 + 1, WAVE))]
    ent = rng.bytes(16 * rows * CHUNKS)
    xs = xs_all[sl]
    corrupt = dict(members)
    c_rows = members[3][1].copy()
    c_rows[2, CHUNKS // 8] += 1
    corrupt[3] = (members[3][0], c_rows, members[3][2])

    # the plane's one-time costs, outside the intake's counts
    with crypto_switch(arm=True):
        t0 = time.perf_counter()
        kernels.prewarm(d)
        prewarm_s = time.perf_counter() - t0
        prewarm_b3 = cl.launches()
        cv.oncurve_mask.launches = 0
        cl.reset_launches()
        card = _settled_intake(members, waves, xs, rows, ent)
        card_bad = _settled_intake(corrupt, [honest], xs, rows, ent)
        b2_launches = cv.oncurve_mask.launches
        b3_launches = cl.launches()
        agg = ss.aggregate_shares(np.stack([made[s][3] for s in honest]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec_card = ss.recover_update(agg, xs_all, d)
        rec_card_s = time.perf_counter() - t0
    cl.reset_launches()
    cpu = _settled_intake(members, waves, xs, rows, ent)
    cpu_bad = _settled_intake(corrupt, [honest], xs, rows, ent)
    cpu_b3 = cl.launches()
    t0 = time.perf_counter()
    rec_cpu = ss.recover_update(agg, xs_all, d)
    rec_cpu_s = time.perf_counter() - t0
    want = np.sum([made[s][0] for s in honest], axis=0).astype(np.float64) \
        / 10.0 ** cfg.precision

    def run_row(r):
        return {"rejected": r[0], "b2_launches_per_fold": r[1],
                "settled": r[2], "members": len(r[3]), "fold_s": r[4],
                "settle_s": r[5]}

    row = {"d": d, "chunks": CHUNKS, "poly": POLY, "total_shares": total,
           "rows_per_miner": rows, "workers": WAVE, "waves": [len(w) for w
                                                              in waves],
           "bad_sid": bad_sid, "native_loaded": True,
           "worker_s": worker_s, "prewarm_s": prewarm_s,
           "card": run_row(card), "cpu_native": run_row(cpu),
           "corrupted_row": {"card": run_row(card_bad),
                             "cpu_native": run_row(cpu_bad)},
           "b2_launches": b2_launches, "b3_launches": b3_launches,
           "b3_launches_prewarm": prewarm_b3,
           "recover_card_exact": bool(np.array_equal(rec_card, want)),
           "recover_cpu_exact": bool(np.array_equal(rec_cpu, want)),
           "recover_card_s": rec_card_s, "recover_cpu_s": rec_cpu_s,
           "nvidia_smi": bench.card_line(),
           "seconds": time.perf_counter() - t_phase}
    emit("secagg", **row)
    for a, b in ((card, cpu), (card_bad, cpu_bad)):
        if (a[0], a[2], a[3]) != (b[0], b[2], b[3]):
            raise AssertionError("card and CPU intakes disagree")
    if card[0] != [[bad_sid], []] or card_bad[0] != [[]]:
        raise AssertionError(f"the intake evicted {card[0]}, not [{bad_sid}] "
                             "at the first fold")
    if card[1] != [1, 1] or card_bad[1] != [1] or b2_launches != 3:
        raise AssertionError(f"B2 launched {card[1]} + {card_bad[1]} times, "
                             "not once a fold")
    if cpu[1] != [0, 0] or cpu_bad[1] != [0]:
        raise AssertionError("B2 launched on the disarmed intake")
    if min(b3_launches.values()) < 1 or any(cpu_b3.values()):
        raise AssertionError(f"B3 launched {b3_launches} armed and {cpu_b3} "
                             "disarmed: every kernel armed, none disarmed")
    if not card[2] or card[3] != honest or card_bad[3] != honest:
        raise AssertionError("the honest intake did not settle True")
    if card_bad[2] or cpu_bad[2]:
        raise AssertionError("a corrupted share row settled True")
    if not (row["recover_card_exact"] and row["recover_cpu_exact"]):
        raise AssertionError("recover_update is not Σq / 10^4 exactly")
    return row


# the CNN families and the datasets they run on (biscotti_tpu_torch/models/zoo.py)
CNNS = [("mnist_cnn", "mnist", 164_266), ("cifar_cnn", "cifar", 62_006),
        ("lfw_cnn", "lfw", 133_000)]
# eval/eval_sim_scale.py's largest row, the main configuration
MAIN = dict(dataset="mnist", num_nodes=1024, sample_percent=0.70,
            verification=True, noising=True, epsilon=1.0, batch_size=10,
            poison_fraction=0.3, seed=0)


def close_to(got, ref, rtol: float = RTOL) -> bool:
    """got within rtol of ref, with atol rtol·max|ref| (float32 sums in
    another order on the card)."""
    import torch

    got, ref = got.cpu(), ref.cpu()
    return bool(torch.allclose(got, ref, rtol=rtol,
                               atol=rtol * float(ref.abs().max())))


def round_card_vs_cpu(card, cpu, w, stake, draws) -> dict:
    """One round from the same weights and draws on the card and on the
    CPU port: masks and stakes must be equal and w within RTOL."""
    import torch

    g = card.round_step_from_draws(w, stake, *draws)
    c = cpu.round_step_from_draws(w.cpu(), stake.cpu(), *(t.cpu() for t in draws))
    row = {"mask_equal": bool(torch.equal(g[2].cpu(), c[2])),
           "stake_equal": bool(torch.equal(g[1].cpu(), c[1])),
           "w_equal_within_rtol": close_to(g[0], c[0]),
           "w_max_abs_diff": float((g[0].cpu() - c[0]).abs().max()),
           "accepted": int(g[2].sum()), "err_card": float(g[3]),
           "err_cpu": float(c[3])}
    if not (row["mask_equal"] and row["stake_equal"]
            and row["w_equal_within_rtol"]):
        raise AssertionError(f"card and CPU rounds disagree: {row}")
    return row


def models_phase(dev) -> dict:
    """Each CNN family on the card against the CPU port, from flat_init
    weights: the forward pass and the simulator's per-contributor step
    (S = 8, batch 10, `Simulator.local_updates`), with the TF32 switches of
    matmuls and cuDNN on outside it: the step must turn them off itself."""
    from dataclasses import replace

    import torch

    from biscotti_tpu_torch.config import BiscottiConfig
    from biscotti_tpu_torch.models.base import fp32_math
    from biscotti_tpu_torch.models.zoo import MODELS
    from biscotti_tpu_torch.parallel.sim import Simulator

    t_phase = time.perf_counter()
    rows = []
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        for family, dataset, params in CNNS:
            model = MODELS[family](dataset)
            seen = []

            def loss(w, x, y, _loss=model.loss_flat, _seen=seen):
                _seen.append((torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32))
                return _loss(w, x, y)

            probe = replace(model, loss_flat=loss)
            cfg = BiscottiConfig(dataset=dataset, model_name=family,
                                 num_nodes=14, noising=False, seed=0)  # S = 8
            card = Simulator(cfg, model=probe)
            cpu = Simulator(cfg, device="cpu", model=probe)
            w = model.flat_init(torch.Generator().manual_seed(1))
            cidx, bidx, noise, _ = cpu.draw_round(cpu.gen, 0)
            on_card = [t.to(dev) for t in (w, cidx, bidx, noise)]
            d_card = card.local_updates(*on_card)[0]
            d_again = card.local_updates(*on_card)[0]
            d_cpu = cpu.local_updates(w, cidx, bidx, noise)[0]
            torch.cuda.synchronize()
            with fp32_math():
                logits = model.apply_flat(on_card[0], card.x_val[:256])
            ref_logits = model.apply_flat(w, cpu.x_val[:256])
            rows.append({
                "family": family, "num_params": model.num_params,
                "contributors": int(cidx.shape[0]), "batch": cfg.batch_size,
                "logits_equal_within_rtol": close_to(logits, ref_logits),
                "logits_max_abs_diff": float((logits.cpu() - ref_logits).abs().max()),
                "step_equal_within_rtol": close_to(d_card, d_cpu),
                "step_max_abs_diff": float((d_card.cpu() - d_cpu).abs().max()),
                "step_max_abs": float(d_cpu.abs().max()),
                "matmul_allow_tf32_in_step": sorted({m for m, _ in seen}),
                "cudnn_allow_tf32_in_step": sorted({c for _, c in seen}),
                "step_bit_identical": bool(torch.equal(d_card, d_again))})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    emit("models", families=rows, seconds=time.perf_counter() - t_phase)
    for (family, _, params), row in zip(CNNS, rows):
        if row["num_params"] != params:
            raise AssertionError(f"{family}: {row['num_params']} parameters")
        if not (row["logits_equal_within_rtol"] and row["step_equal_within_rtol"]):
            raise AssertionError(f"{family}: card and CPU disagree: {row}")
        if row["matmul_allow_tf32_in_step"] != [False] \
                or row["cudnn_allow_tf32_in_step"] != [False]:
            raise AssertionError(f"{family}: the step ran with TF32 on")
    return {"families": rows}


def defenses_phase(dev) -> dict:
    """One round of each defense at the main configuration: a warm round,
    3 timed rounds, then one round's draws on the card and on the CPU
    port. B1 must launch once a round under KRUM and MULTIKRUM, and never
    under the others."""
    import torch

    from biscotti_tpu_torch.config import BiscottiConfig, Defense
    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.parallel.sim import Simulator

    kern = krum_cuda.krum_scores_kernel
    t_phase = time.perf_counter()
    rows, launches = {}, 0
    for d in (Defense.KRUM, Defense.MULTIKRUM, Defense.FOOLSGOLD, Defense.RONI,
              Defense.TRIMMED_MEAN, Defense.NONE, Defense.ENSEMBLE):
        cfg = BiscottiConfig(defense=d, secure_agg=d != Defense.TRIMMED_MEAN,
                             **MAIN)
        sim = Simulator(cfg)
        w, stake = sim.init_state()
        w, stake, _, _ = sim.round_step(w, stake, 0)  # warm
        torch.cuda.synchronize()
        per_round, ms = [], []
        for it in range(1, 4):
            before = kern.launches
            t0 = time.perf_counter()
            w, stake, mask, err = sim.round_step(w, stake, it)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            per_round.append(kern.launches - before)
        launches += sum(per_round)
        want = 1 if d in (Defense.KRUM, Defense.MULTIKRUM) else 0
        row = {"round_ms": ms, "round_ms_median": statistics.median(ms),
               "b1_launches_per_round": per_round, "accepted": int(mask.sum()),
               "error": float(err)}
        cpu = Simulator(cfg, device="cpu")
        row["card_vs_cpu"] = round_card_vs_cpu(sim, cpu, w, stake,
                                               sim.draw_round(sim.gen, 4))
        rows[d.value] = row
        del sim, cpu
        if per_round != [want] * 3:
            raise AssertionError(f"{d.value}: B1 launched {per_round} times in "
                                 f"3 rounds, not {want} a round")
    emit("defenses", nodes=MAIN["num_nodes"], defenses=rows, b1_launches=launches,
         seconds=time.perf_counter() - t_phase)
    return {"defenses": rows, "b1_launches": launches}


def cnn_phase(dev) -> dict:
    """The mnist CNN at the main configuration's scale (d = 164,266): 2 warm
    and 5 timed rounds with B1 once a round at (716, 164266), B1 against
    its plain version on one round's noised updates from flat_init
    weights, and a torch.profiler window (`device_trace`) over 3 rounds."""
    import tempfile

    import torch

    from biscotti_tpu_torch.config import BiscottiConfig, Defense
    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.ops.krum import default_num_adversaries
    from biscotti_tpu_torch.parallel.sim import Simulator
    from biscotti_tpu_torch.utils.profiling import device_trace

    kern, plain = krum_cuda.krum_scores_kernel, krum_cuda.krum_scores_plain
    t_phase = time.perf_counter()
    cfg = BiscottiConfig(defense=Defense.KRUM, model_name="mnist_cnn", **MAIN)
    t0 = time.perf_counter()
    sim = Simulator(cfg)
    setup_s = time.perf_counter() - t0
    s, n = cfg.num_samples, sim.num_params
    f = default_num_adversaries(s)
    w, stake = sim.init_state()
    for it in range(2):
        w, stake, mask, err = sim.round_step(w, stake, it)
    torch.cuda.synchronize()
    kern.launches = 0
    round_ms = []
    for it in range(2, 7):
        before = kern.launches
        t0 = time.perf_counter()
        w, stake, mask, err = sim.round_step(w, stake, it)
        torch.cuda.synchronize()
        round_ms.append(1e3 * (time.perf_counter() - t0))
        if kern.launches - before != 1:
            raise AssertionError(f"cnn round {it} launched B1 "
                                 f"{kern.launches - before} times, not once")
    launches = kern.launches
    if not (w.shape == (n,) and bool(torch.isfinite(w).all())):
        raise AssertionError("cnn path: w is not finite or has the wrong shape")
    if int(mask.sum()) != s - f:
        raise AssertionError(f"cnn path: {int(mask.sum())} accepted, not {s - f}")

    # B1 against its plain version on one round's noised updates
    w0 = sim.model.flat_init(torch.Generator(device=dev).manual_seed(3))
    cidx, bidx, noise, _ = sim.draw_round(sim.gen, 7)
    deltas, noised = sim.local_updates(w0, cidx, bidx, noise)
    got, ref = kern(noised, f), plain(noised, f)
    torch.cuda.synchronize()
    err_rel = rel_err(got, ref)
    kernel = {"n": s, "d": n, "max_abs_err": float((got - ref).abs().max()),
              "max_rel_err": err_rel,
              "accept_set_identical": accept_set(got, s - f) == accept_set(ref, s - f),
              "boundary_rel_gap": boundary_rel_gap(ref, s - f),
              **krum_times(noised, f)}
    kernel["rel_err_over_half_gap"] = err_rel / (kernel["boundary_rel_gap"] / 2)
    if not err_rel < kernel["boundary_rel_gap"] / 2:
        truth = krum_scores_fp64(noised, f)
        kernel["kernel_vs_fp64_rel_err"] = rel_err(got.double(), truth)
        kernel["plain_vs_fp64_rel_err"] = rel_err(ref.double(), truth)
    # the ledger phase's plain-mode block: the first LEDGER_CNN_ROWS
    # accepted contributors of this round, their ids and updates
    accepted = sorted(accept_set(got, s - f))[:LEDGER_CNN_ROWS]
    ledger_rows = {"ids": cidx[accepted].tolist(),
                   "rows": deltas[accepted].double().cpu().numpy(),
                   "w": w.double().cpu().numpy()}
    del deltas, noised, noise

    # where a round's time goes
    prof_rounds = 3
    with tempfile.TemporaryDirectory() as log_dir:
        t0 = time.perf_counter()
        with device_trace(log_dir) as prof:
            pw, pstake = w, stake
            for it in range(7, 7 + prof_rounds):
                pw, pstake, _, _ = sim.round_step(pw, pstake, it)
        host_ms = 1e3 * (time.perf_counter() - t0) / prof_rounds
        trace_mb = os.path.getsize(os.path.join(log_dir, "trace.json")) / 2**20
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3 / prof_rounds
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]
    profile_row = {
        "rounds": prof_rounds, "device_ms_per_round": device_ms,
        "host_ms_per_round_profiled": host_ms,
        "device_idle_share": 1.0 - device_ms / statistics.median(round_ms),
        "kernels_per_round": sum(e.count for e in on_device) / prof_rounds,
        "trace_mb": trace_mb,
        "top": [{"name": e.key[:100],
                 "ms_per_round": e.self_device_time_total / 1e3 / prof_rounds,
                 "calls_per_round": e.count / prof_rounds} for e in top]}
    emit("cnn", model="mnist_cnn", nodes=cfg.num_nodes, contributors=s,
         params=n, update_gb=4.0 * s * n / 1e9, setup_s=setup_s,
         round_ms=round_ms, round_ms_median=statistics.median(round_ms),
         b1_launches=launches, accepted=int(mask.sum()), error=float(err),
         kernel=kernel, profile=profile_row,
         seconds=time.perf_counter() - t_phase)
    if not (err_rel < RTOL and kernel["accept_set_identical"]):
        raise AssertionError("B1 disagrees with plain at the mnist CNN width")
    # below half the boundary gap, or (where the plain version's own error
    # against float64 exceeds that) no less exact than plain
    if "kernel_vs_fp64_rel_err" in kernel and not (
            kernel["plain_vs_fp64_rel_err"] > kernel["boundary_rel_gap"] / 2
            and kernel["kernel_vs_fp64_rel_err"]
            <= EXACT_SLACK * kernel["plain_vs_fp64_rel_err"]):
        raise AssertionError(f"B1 error at the mnist CNN width: {kernel}")
    return {"kernel": kernel, "b1_launches": launches,
            "ledger_rows": ledger_rows}


def bench_phase(dev) -> dict:
    """The eight BASELINE rows through `biscotti_tpu_torch.bench`, then one
    round of each CNN row on the card and on the CPU port, on the same
    draws, from flat_init weights."""
    import torch

    from biscotti_tpu_torch import bench
    from biscotti_tpu_torch.parallel.sim import Simulator

    t_phase = time.perf_counter()
    out = bench.run(device=dev)
    parity = {}
    for name in ("cifar_lenet_100_krum_secagg", "mnist_cnn_100_krum_secagg",
                 "lfw_cnn_100_krum_secagg"):
        cfg = bench.config(name)
        card, cpu = Simulator(cfg), Simulator(cfg, device="cpu")
        w = card.model.flat_init(torch.Generator(device=dev).manual_seed(4))
        stake = card.init_state()[1]
        parity[name] = round_card_vs_cpu(card, cpu, w, stake,
                                         card.draw_round(card.gen, 0))
        del card, cpu
    emit("bench", **out, card_vs_cpu=parity, seconds=time.perf_counter() - t_phase)
    crypto_keys = ("worker_crypto_s", "miner_fold_s", "miner_crypto_s",
                   "miner_crypto_oneshot_s", "recovery_s", "round_total_s",
                   "round_total_pipelined_s")
    for name, row in out["rows"].items():
        if not (0 < row["wire_bytes_per_round_f32_zlib"]
                < row["wire_bytes_per_round"]
                and 0 < row["cross_host_bytes_per_round_overlay"]
                < row["cross_host_bytes_per_round"]
                and row["wire_compression_x"] >= 1.0
                and row["overlay_cross_host_saving_x"] >= 1.0):
            raise AssertionError(f"bench row {name}'s byte columns: {row}")
        if not (row["device_round_s"] > 0 and 0.0 <= row["final_error"] <= 1.0):
            raise AssertionError(f"bench row {name}: {row}")
        if not (row["share_pipeline_roundtrip_ok"] is True
                and all(row[k] > 0 for k in crypto_keys)):
            raise AssertionError(f"bench row {name}'s crypto half: {row}")
    if "miner_crypto_device_s" not in out["rows"]["creditcard_10"] \
            or out["headline"]["value"] <= 0 or not out["native_ec_plane"]:
        raise AssertionError("bench: no device settle on creditcard_10, no "
                             "headline, or not on the native EC plane")
    return out


def trainer_phase(dev) -> dict:
    """The per-peer Trainer on the card against the CPU port (mnist softmax
    and mnist_cnn, flat_init weights, the card's own batch rows fed to the
    CPU's pure step), one private_fun's time, and mcmc13 Trainers at
    d = 7,850 and 164,266: acceptance, mean row norm against 2d/ε, and the
    presample's time."""
    import torch

    from biscotti_tpu_torch.config import BiscottiConfig
    from biscotti_tpu_torch.models.trainer import Trainer
    from biscotti_tpu_torch.ops import dp_noise

    t_phase = time.perf_counter()
    api = {}
    for model_name, shard in (("", "mnist3"), ("mnist_cnn", "mnist1")):
        cfg = BiscottiConfig(dataset="mnist", model_name=model_name, seed=0)
        card = Trainer("mnist", shard, cfg=cfg)
        cpu = Trainer("mnist", shard, cfg=cfg, device="cpu")
        w = card.model.flat_init(torch.Generator().manual_seed(3)).numpy()
        delta = card.private_fun(w, 0)
        ref = cpu.private_fun_from_batch(w, card.batch_indices(0).cpu())
        times = []
        for it in range(6):
            t0 = time.perf_counter()
            card.private_fun(w, it)
            times.append(1e3 * (time.perf_counter() - t0))
        n_train, n_test = len(cpu.x_train), len(cpu.x_test)
        n_attack = len(cpu.x_attack)
        gaps = {"train_error": (card.train_error(w) - cpu.train_error(w)) * n_train,
                "test_error": (card.test_error(w) - cpu.test_error(w)) * n_test,
                "attack_rate": (card.attack_rate(w) - cpu.attack_rate(w)) * n_attack,
                "attack_success_rate": (card.attack_success_rate(w)
                                        - cpu.attack_success_rate(w)) * n_attack,
                "roni": (card.roni(w, delta) - cpu.roni(w, delta)) * n_train}
        row = {"model": card.model.name, "params": card.num_params,
               "private_fun_equal_within_rtol": close_to(
                   torch.from_numpy(delta), torch.from_numpy(ref)),
               "private_fun_max_abs_diff": float(np.abs(delta - ref).max()),
               "metric_gaps_in_samples": gaps,
               "private_fun_ms": statistics.median(times[1:]),
               "noise_finite": bool(np.isfinite(card.get_noise(3)).all())}
        api[row["model"]] = row
        if not row["private_fun_equal_within_rtol"] or not row["noise_finite"]:
            raise AssertionError(f"Trainer card vs CPU: {row}")
        if max(abs(g) for g in gaps.values()) > 2.0 + 1e-3:
            raise AssertionError(f"Trainer metrics differ by more than a "
                                 f"sample or two: {gaps}")
    mcmc = {}
    for model_name in ("", "mnist_cnn"):
        cfg = BiscottiConfig(dataset="mnist", model_name=model_name,
                             dp_mechanism="mcmc13", noise_presample_iters=100,
                             epsilon=1.0, seed=0)
        t0 = time.perf_counter()
        tr = Trainer("mnist", "mnist0", cfg=cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        d = tr.num_params
        gen = torch.Generator(device=dev).manual_seed(1)
        presample_s, _ = host_s(lambda: (dp_noise.mcmc_presample(gen, 1.0, 100, d),
                                         torch.cuda.synchronize()))
        norms = torch.linalg.vector_norm(tr.noise_samples.double(), dim=1)
        want = 2.0 * d / cfg.epsilon
        row = {"d": d, "rows": int(tr.noise_samples.shape[0]),
               "walkers": dp_noise.mcmc_walkers(100),
               "accept_rate": tr.noise_accept_rate,
               "mean_row_norm": float(norms.mean()), "law_mean": want,
               "mean_rel_dev": float(norms.mean()) / want - 1.0,
               "trainer_build_s": build_s, "presample_s": presample_s}
        mcmc[str(d)] = row
        if abs(row["mean_rel_dev"]) > 0.01 or not 0.15 < row["accept_rate"] < 0.35:
            raise AssertionError(f"mcmc13 presample off its law: {row}")
    emit("trainer", api=api, mcmc13=mcmc, seconds=time.perf_counter() - t_phase)
    return {"api": api, "mcmc13": mcmc}


def _chunk_frames(frame: bytes) -> int:
    """Frames on the wire in one encoded message: 1, or its chunk run."""
    import struct

    off, n = 0, 0
    while off < len(frame):
        (ln,) = struct.unpack(">I", frame[off:off + 4])
        off, n = off + 4 + ln, n + 1
    return n


def _reassembled(frame: bytes) -> bytes:
    """The payload of one encoded message, its chunk run reassembled."""
    import struct

    from biscotti_tpu_torch.runtime import messages as msgs

    if frame[4:8] != msgs.CHUNK_MAGIC:
        return frame[4:]
    out, off = [], 0
    while off < len(frame):
        (ln,) = struct.unpack(">I", frame[off:off + 4])
        out.append(frame[off + 4 + msgs.CHUNK_OVERHEAD:off + 4 + ln])
        off += 4 + ln
    return b"".join(out)


def ledger_phase(dev, sim, w, stake, cnn_rows: dict, first_round: int) -> dict:
    """The ledger and wire plane on the card's own outputs: LEDGER_ROUNDS
    rounds of `sim` (the main configuration) sealed into secure-agg blocks
    on a Blockchain of its nodes, one plain-mode mnist_cnn block of
    `cnn_rows` on a chain of its own, every block sent through the port's
    Pool to the port's RPCServer under each of LEDGER_CODECS, a checkpoint
    round trip, and the bench's byte columns for the configuration.
    Returns the phase's row (with B1's launches in its rounds)."""
    import asyncio
    import hashlib
    import tempfile

    import torch

    from biscotti_tpu_torch import bench
    from biscotti_tpu_torch.ledger.block import Block, BlockData, Update
    from biscotti_tpu_torch.ledger.chain import Blockchain, ChainInvariantError
    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.runtime import codecs as wcodecs
    from biscotti_tpu_torch.runtime import messages as msgs
    from biscotti_tpu_torch.runtime import rpc
    from biscotti_tpu_torch.runtime import wire
    from biscotti_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    cfg = sim.cfg
    f32 = wcodecs.get("f32+zlib")

    # the card's rounds, each sealed and appended
    main_chain = Blockchain(sim.num_params, cfg.num_nodes, cfg.default_stake)
    kern = krum_cuda.krum_scores_kernel
    kern.launches = 0
    seal_s, accepted = [], 0
    for it in range(first_round, first_round + LEDGER_ROUNDS):
        draws = sim.draw_round(sim.gen, it)
        deltas, _ = sim.local_updates(w, *draws[:3])
        w, stake, mask, _ = sim.round_step_from_draws(w, stake, *draws)
        ids = draws[0][mask].tolist()
        rows = deltas[mask].cpu().numpy()
        t0 = time.perf_counter()
        blk = Block(
            data=BlockData(iteration=main_chain.next_iteration,
                           global_w=f32.transform_dense(w.double().cpu().numpy()),
                           deltas=[Update(source_id=int(c), iteration=it,
                                          delta=np.zeros(0, np.float64),
                                          commitment=hashlib.sha256(
                                              r.tobytes()).digest(),
                                          accepted=True)
                                   for c, r in zip(ids, rows)]),
            prev_hash=main_chain.latest_hash(),
            stake_map={i: int(v) for i, v in enumerate(stake.tolist())}).seal()
        if not main_chain.consider_block(blk):
            raise AssertionError(f"the card's round {it} did not append")
        seal_s.append(time.perf_counter() - t0)
        accepted = len(ids)
    b1_launches = kern.launches
    w64 = w.double().cpu().numpy()

    # the plain-mode mnist_cnn block, on a chain of its own
    d_cnn = cnn_rows["rows"].shape[1]
    cnn_chain = Blockchain(d_cnn, cfg.num_nodes, cfg.default_stake)
    cnn_blk = Block(
        data=BlockData(iteration=0, global_w=f32.transform_dense(cnn_rows["w"]),
                       deltas=[Update(source_id=int(c), iteration=0, delta=r,
                                      commitment=hashlib.sha256(
                                          r.tobytes()).digest(), accepted=True)
                               for c, r in zip(cnn_rows["ids"],
                                               cnn_rows["rows"])]),
        prev_hash=cnn_chain.latest_hash(),
        stake_map=cnn_chain.latest_stake_map()).seal()
    if not cnn_chain.consider_block(cnn_blk):
        raise AssertionError("the mnist_cnn block did not append")
    sources = {"main": main_chain, "mnist_cnn": cnn_chain}

    # encode and decode each block kind once, timed
    kinds = {}
    for kind, chain in sources.items():
        blk = chain.latest
        row = {"blocks": len(chain) - 1, "deltas": len(blk.data.deltas),
               "params": int(blk.data.global_w.size)}
        for codec in LEDGER_CODECS:
            meta, arrays = wire.pack_block(blk)
            t0 = time.perf_counter()
            frame = msgs.encode("RegisterBlock", meta, arrays,
                                codec=None if codec == wcodecs.RAW else codec,
                                chunk_bytes=cfg.wire_chunk_bytes)
            enc_s = time.perf_counter() - t0
            payload = _reassembled(frame)
            t0 = time.perf_counter()
            _, dmeta, darrays = msgs.decode(payload)
            back = wire.unpack_block(dmeta, darrays)
            dec_s = time.perf_counter() - t0
            if back.hash != blk.hash or back.compute_hash() != blk.hash:
                raise AssertionError(f"{kind} block under {codec} decodes to "
                                     "another hash")
            row[codec] = {"frame_bytes": len(frame),
                          "frames": _chunk_frames(frame),
                          "encode_s": enc_s, "decode_s": dec_s}
        row["codec_ratio"] = (row["raw64"]["frame_bytes"]
                              / row["f32+zlib"]["frame_bytes"])
        kinds[kind] = row

    # the RPC hop: every block to a port RPCServer, appended on its side
    received = {(kind, codec): Blockchain(chain.blocks[0].data.global_w.size,
                                          cfg.num_nodes, cfg.default_stake)
                for kind, chain in sources.items() for codec in LEDGER_CODECS}

    async def handle(msg_type, meta, arrays):
        if msg_type != "RegisterBlock":
            raise rpc.RPCError(f"unexpected {msg_type}")
        blk = wire.unpack_block(meta, arrays)
        chain = received[(meta["chain"], meta["codec"])]
        return {"appended": chain.consider_block(blk),
                "hash": blk.hash.hex()}, {}

    async def hop():
        server = rpc.RPCServer("127.0.0.1", 0, handle)
        server.caps = wcodecs.FULL_CAPS
        await server.start()
        port = server._server.sockets[0].getsockname()[1]
        pool = rpc.Pool()
        sent = []
        try:
            for kind, chain in sources.items():
                for codec in LEDGER_CODECS:
                    for blk in chain.blocks[1:]:
                        meta, arrays = wire.pack_block(blk)
                        meta.update(chain=kind, codec=codec)
                        t0 = time.perf_counter()
                        reply, _ = await pool.call(
                            "127.0.0.1", port, "RegisterBlock", meta, arrays,
                            timeout=300.0, codec=codec,
                            chunk_bytes=cfg.wire_chunk_bytes)
                        sent.append((kind, codec, time.perf_counter() - t0,
                                     reply["appended"],
                                     reply["hash"] == blk.hash.hex()))
        finally:
            pool.close()
            await server.stop()
        return sent

    sent = asyncio.run(hop())
    for kind, row in kinds.items():
        for codec in LEDGER_CODECS:
            mine = [x for x in sent if x[:2] == (kind, codec)]
            rx = received[(kind, codec)]
            row[codec].update(
                send_s=[x[2] for x in mine],
                all_appended=all(x[3] for x in mine),
                hashes_equal=all(x[4] for x in mine),
                dump_equal=rx.dump() == sources[kind].dump())
            try:
                rx.verify()
                row[codec]["verify"] = True
            except ChainInvariantError as e:  # reported, then raised below
                row[codec]["verify"] = str(e)

    # checkpoint save/load round trip
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ckpt = {}
        for kind, chain in sources.items():
            t0 = time.perf_counter()
            checkpoint.save(chain, os.path.join(ckpt_dir, kind))
            loaded = checkpoint.load(os.path.join(ckpt_dir, kind))
            ckpt[kind] = {"dump_equal": loaded.dump() == chain.dump(),
                          "save_load_s": time.perf_counter() - t0}

    out = {"rounds": LEDGER_ROUNDS, "nodes": cfg.num_nodes,
           "accepted_last_round": accepted, "seal_s": seal_s,
           "b1_launches": b1_launches, "blocks": kinds, "checkpoint": ckpt,
           "bench_byte_columns": bench.byte_columns(cfg, w64, accepted),
           "chunk_bytes": cfg.wire_chunk_bytes,
           "nvidia_smi": bench.card_line(),
           "seconds": time.perf_counter() - t_phase}
    emit("ledger", **out)
    if b1_launches != LEDGER_ROUNDS:
        raise AssertionError(f"ledger rounds launched B1 {b1_launches} times")
    for kind, row in kinds.items():
        for codec in LEDGER_CODECS:
            r = row[codec]
            if not (r["all_appended"] and r["hashes_equal"] and r["dump_equal"]
                    and r["verify"] is True):
                raise AssertionError(f"ledger: the {kind} chain under {codec} "
                                     f"differs after the RPC hop: {r}")
        if not ckpt[kind]["dump_equal"]:
            raise AssertionError(f"ledger: the {kind} checkpoint round trip "
                                 "differs")
    if kinds["mnist_cnn"]["raw64"]["frames"] < 2:
        raise AssertionError("ledger: the mnist_cnn block was not chunked")
    return out


def free_base(port: int, n: int) -> int:
    """The first base port from `port` up whose n ports 127.0.0.1 can bind
    now, as the peers' servers bind them (SO_REUSEADDR): the card
    machine's ephemeral range reaches into the live and hive clusters'
    ports, and an outbound socket of an earlier cluster in this process can
    hold one past RPCServer.start's retry window (17526 once, after live
    (b)'s 7-peer rounds; 18082 once, at hive (b)). Right after the two
    hives of 50, whose thousands of connections span that range, a scan
    once found no run of 100 bindable ports from 20300 up, so the scan is
    made again each second for up to 90 s; a window holding a port that
    cannot bind is skipped past that port."""
    import socket

    def bindable(p: int) -> bool:
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("127.0.0.1", p))
            except OSError as e:
                nonlocal err
                err = e
                return False
        return True

    deadline = time.monotonic() + 90.0
    while True:
        err, base = None, port
        while base + n <= 65536:
            held = next((p for p in range(base, base + n)
                         if not bindable(p)), None)
            if held is None:
                return base
            base = held + 1
        if time.monotonic() > deadline:
            raise AssertionError(f"no {n} free ports from {port} up: "
                                 f"{err!r}")
        time.sleep(1.0)


def trainer_devices(agents) -> list:
    """The devices the agents' Trainers hold their data on."""
    return sorted({str(a.trainer.x_test.device) for a in agents})


def live_cluster(name: str, port: int, timeouts: dict, peers: int,
                 classes: dict | None = None, agent_kw: dict | None = None,
                 **kw) -> dict:
    """`peers` port PeerAgents on the card (device None: the GPU) in one
    event loop over loopback TCP, run to the end; the cluster's row, with
    the chain-equality oracle checked over the honest peers. `classes`
    maps a node id to the PeerAgent subclass it runs (a Byzantine peer,
    whose own chain the oracle skips). Round wall times are the gaps
    between the first honest peer's per-round log stamps, the first from
    the run's start. `verdicts` lists each verifier decision as [round,
    pool, accepted]; under KRUM with a pool of 5 or more, Krum must have
    rejected an update in some round (a pool under 5 scores on no
    neighbour, and one of 2 or less is accepted whole). `accepted`,
    `rejected` and `stake` are what the first honest peer's chain
    recorded; `counters` sums the peers' LIVE_COUNTERS. `agent_kw` goes to
    every PeerAgent (a `key_dir`); the row also has the accepted records'
    commitment lengths, the peers holding a commit key and the block
    gossip's bytes out by codec (`gossip_bytes`)."""
    import asyncio

    from biscotti_tpu_torch.config import BiscottiConfig, Defense, Timeouts

    port = free_base(port, peers)
    base = dict(num_nodes=peers, base_port=port, num_verifiers=1,
                num_miners=1, num_noisers=1, sample_percent=1.0,
                convergence_error=0.0, seed=0, defense=Defense.KRUM,
                timeouts=Timeouts(**timeouts))
    base.update(kw)
    cfgs = [BiscottiConfig(node_id=i, **base) for i in range(peers)]
    classes = classes or {}
    honest = [i for i in range(peers) if i not in classes]

    async def go():
        from biscotti_tpu_torch.runtime.peer import PeerAgent

        agents = [classes.get(c.node_id, PeerAgent)(c, **(agent_kw or {}))
                  for c in cfgs]
        t0 = time.time()
        results = await asyncio.gather(*(a.run() for a in agents))
        return agents, t0, time.time() - t0, results

    t_setup = time.perf_counter()
    agents, t0, run_s, results = asyncio.run(go())
    anchor = agents[honest[0]]
    dumps = [results[i]["chain_dump"] for i in honest]
    blocks = dumps[0].splitlines()[1:]
    stamps = log_stamps(results[honest[0]])
    stream = sorted((int(v["it"]), [int(x) for x in v["src"]],
                     [bool(x) for x in v["accept"]])
                    for r in results
                    for v in r["telemetry"].get("trust", {}).get("stream", []))
    verdicts = [[it, len(src), sum(acc)] for it, src, acc in stream]
    row = {"cluster": name, "peers": peers, "base_port": port,
           "dataset": cfgs[0].dataset,
           "model": cfgs[0].model_name or "default",
           "params": agents[0].trainer.num_params,
           "devices": trainer_devices(agents),
           "secure_agg": cfgs[0].secure_agg,
           "device_crypto": cfgs[0].device_crypto,
           "chains_equal": all(d == dumps[0] for d in dumps),
           "rounds": len(blocks), "rounds_wanted": cfgs[0].max_iterations,
           "nonempty_blocks": sum("ndeltas=0" not in b for b in blocks),
           "verdicts": verdicts,
           "round_wall_s": round_walls(t0, stamps),
           "run_s": run_s, "setup_and_run_s": time.perf_counter() - t_setup,
           "final_error": results[0]["final_error"],
           "phases_total_s": summed_phases(results),
           "chain": blocks,
           # what each round decided, to tell two chains' first difference
           # apart: the verifiers' pools and accept masks, each block's
           # contributors
           "pools": stream,
           "block_sources": [sorted(u.source_id for u in b.data.deltas)
                             for b in anchor.chain.blocks[1:]]}
    records = [u for b in anchor.chain.blocks for u in b.data.deltas]
    row.update(
        byzantine={i: cls.__name__ for i, cls in sorted(classes.items())},
        accepted=sorted(u.source_id for u in records if u.accepted),
        rejected=sorted(u.source_id for u in records if not u.accepted),
        stake=dict(sorted(anchor.chain.latest_stake_map().items())),
        default_stake=cfgs[0].default_stake,
        counters={k: sum(r["counters"].get(k, 0) for r in results)
                  for k in LIVE_COUNTERS},
        commitment_lengths=sorted({len(u.commitment) for u in records
                                   if u.accepted}),
        keyed_peers=sum(a.commit_key is not None for a in agents),
        gossip_bytes_out=gossip_bytes(results),
        # each honest peer's submission_rejected events, as the reference's
        # device-cluster guard reads them (test_crypto_kernels.py:679-683)
        rejection_evidence=sorted(
            [a.id, ev.get("source"), ev.get("reason")]
            for a in agents if a.id in honest
            for ev in a.tele.recorder.tail(100000)
            if ev.get("event") == "submission_rejected"))
    if not (row["chains_equal"] and row["rounds"] == row["rounds_wanted"]
            and row["nonempty_blocks"] >= 1
            and row["devices"] == ["cuda:0"]):
        raise AssertionError(f"live cluster {name} failed the oracle: {row}")
    krum_pools = cfgs[0].verification and cfgs[0].defense == Defense.KRUM \
        and peers - 2 >= 5
    if krum_pools and not any(pool >= 5 and acc < pool
                              for _, pool, acc in verdicts):
        raise AssertionError(f"live cluster {name}: no live round ran Krum "
                             f"on a pool of 5 or more: {verdicts}")
    return row


def gossip_bytes(results) -> dict:
    """{codec: bytes} the peers sent as RegisterBlock frames (the block
    gossip), from each run's `biscotti_wire_bytes_total`."""
    out: dict = {}
    for r in results:
        fam = r["telemetry"]["metrics"].get("biscotti_wire_bytes_total", {})
        for row in fam.get("series", []):
            lb = row["labels"]
            if lb.get("direction") == "out" \
                    and lb.get("msg_type") == "RegisterBlock":
                out[lb["codec"]] = out.get(lb["codec"], 0) + row["value"]
    return out


def live_seam() -> dict:
    """The verifier seam on the card: an unstarted card PeerAgent and an
    unstarted CPU one (the CPU tests' oracle) give the same accept masks
    for every device defense on a seeded pool at d = 7,850, and the same
    Krum, Multi-Krum and ENSEMBLE masks on C2's x1e-20 rows."""
    from biscotti_tpu_torch.config import BiscottiConfig, Defense
    from biscotti_tpu_torch.runtime.peer import PeerAgent

    cfg = BiscottiConfig(node_id=0, num_nodes=4, dataset="mnist",
                         base_port=LIVE_BASE_PORT + 90, defense=Defense.ENSEMBLE)
    card, cpu = PeerAgent(cfg), PeerAgent(cfg, device="cpu")
    d = card.trainer.num_params
    rng = np.random.default_rng(17)
    pools = {"random_12": rng.normal(0.0, 0.01, (12, d)),
             "c2_1e-20": np.random.default_rng(0).normal(size=(6, d)) * 1e-20}
    # C2's rows only under the Krum rules: at w = 0 RONI and FoolsGold
    # read 1e-20-sized logits and cosines, whose ties no rule fixes
    defenses = {"random_12": (Defense.KRUM, Defense.MULTIKRUM,
                              Defense.FOOLSGOLD, Defense.RONI),
                "c2_1e-20": (Defense.KRUM, Defense.MULTIKRUM)}
    rows = {}
    for pname, vecs in pools.items():
        for defense in defenses[pname]:
            masks = []
            for agent in (card, cpu):
                agent.cfg = agent.cfg.replace(defense=defense)
                masks.append(agent._defense_mask(vecs).tolist())
            rows[f"{pname}/{defense.value}"] = masks[0]
            if masks[0] != masks[1]:
                raise AssertionError(f"live seam: {defense.value} on {pname} "
                                     f"differs card vs CPU: {masks}")
        ens = [agent._ensemble_mask(0, [type("U", (), {"source_id": i})()
                                        for i in range(len(vecs))], vecs)[0]
               for agent in (card, cpu)]
        rows[f"{pname}/ENSEMBLE"] = [bool(b) for b in ens[0]]
        if [bool(b) for b in ens[0]] != [bool(b) for b in ens[1]]:
            raise AssertionError(f"live seam: ENSEMBLE on {pname} differs "
                                 f"card vs CPU")
    keep = 6 - 3
    if rows["c2_1e-20/KRUM"] != [True] * keep + [False] * (6 - keep):
        raise AssertionError(f"live seam: C2's pool is not the reference's "
                             f"accept set: {rows['c2_1e-20/KRUM']}")
    return {"params": d, "masks": rows}


def pooled(row: dict) -> list:
    """[(round, the workers a verifier pooled)] of a live cluster's row."""
    return [(it, src) for it, src, _ in row["pools"]]


def byzantine_peers() -> dict:
    """The Byzantine workers of live (d) and (e) on the port's PeerAgent,
    as the reference's enforcement tests write them
    (tests/test_byzantine.py:86-170): each submission is refused by the
    miners' crypto, never by a defense."""
    from biscotti_tpu_torch.runtime.peer import PeerAgent

    class CorruptSharePeer(PeerAgent):
        """Commits honestly, then ships garbage share rows."""

        def _secret_arrays(self, shares, blind_rows, comms, sl):
            arrays = super()._secret_arrays(shares, blind_rows, comms, sl)
            arrays["share_rows"] = arrays["share_rows"] + 12345
            return arrays

    class ForgedCommitmentPeer(PeerAgent):
        """Gets signatures over a commitment to zeros, shares its real
        update."""

        def _vss_build(self, q, it, *args):
            return super()._vss_build(np.zeros_like(q), it, *args)

    class PlusSharePeer(PeerAgent):
        """Colluder A: +OFFSET on every share row cell."""

        OFFSET = 12345

        def _secret_arrays(self, shares, blind_rows, comms, sl):
            arrays = super()._secret_arrays(shares, blind_rows, comms, sl)
            arrays["share_rows"] = arrays["share_rows"] + self.OFFSET
            return arrays

    class MinusSharePeer(PlusSharePeer):
        """Colluder B: -OFFSET, cancelling A in any batch holding both."""

        OFFSET = -12345

    class LyingListMiner(PeerAgent):
        """A miner that lies colluder B out of its update list."""

        OMIT = -1

        async def _h_get_update_list(self, meta, arrays):
            rmeta, arrs = await super()._h_get_update_list(meta, arrays)
            rmeta["sources"] = [x for x in rmeta["sources"] if x != self.OMIT]
            return rmeta, arrs

    return {c.__name__: c for c in (CorruptSharePeer, ForgedCommitmentPeer,
                                    PlusSharePeer, MinusSharePeer,
                                    LyingListMiner)}


def round0_roles(peers: int, miners: int, params: int) -> tuple:
    """(workers, miners) of round 0: the committees every peer elects from
    the genesis block (its stake map and hash)."""
    from biscotti_tpu_torch.config import BiscottiConfig
    from biscotti_tpu_torch.ledger.chain import Blockchain
    from biscotti_tpu_torch.parallel import roles as R

    chain = Blockchain(params, peers, BiscottiConfig().default_stake)
    v, m = R.elect_committees(chain.latest_stake_map(), chain.latest_hash(),
                              1, miners, peers)
    busy = set(v) | set(m)
    return sorted(i for i in range(peers) if i not in busy), sorted(m)


class IntakeVerdicts:
    """Records every `vss_verify_multi` call of the peers (the one-shot
    intake, its bisection's singles and the aggregation-boundary
    re-check): its instances and the verdict of whichever plane was
    armed. `replay()` computes each call again with the plane disarmed,
    on the native host plane."""

    def __enter__(self):
        from biscotti_tpu_torch.crypto import commitments as cm

        self.cm, self.orig, self.calls = cm, cm.vss_verify_multi, []

        def recording(instances, *a, **k):
            ok = self.orig(instances, *a, **k)
            self.calls.append(([tuple(np.array(x) for x in inst)
                                for inst in instances], bool(ok)))
            return ok

        cm.vss_verify_multi = recording
        return self

    def __exit__(self, *exc):
        self.cm.vss_verify_multi = self.orig

    def verdicts(self) -> list:
        return [[len(insts), ok] for insts, ok in self.calls]

    def replay(self) -> list:
        return [[len(insts), bool(self.orig(insts))]
                for insts, _ in self.calls]


def armed_cluster(name: str, port: int, prewarm_b3: dict, peers: int,
                  timeouts: dict = LIVE_ARMED, **kw) -> dict:
    """live_cluster with the device plane armed on the card and
    BISCOTTI_PALLAS_CRYPTO=1 (B2 once a miner's fold); the row gains B2's
    launches, B3's beyond the peers' prewarms and the plane's calls."""
    from biscotti_tpu_torch.crypto import kernels
    from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv

    with crypto_switch(arm=True):
        row = live_cluster(name, port, timeouts, peers, device_crypto=True,
                           **kw)
        row["b2_launches"] = cv.oncurve_mask.launches
        row["b3_launches"] = cl.launches()
        row["device_crypto_calls"] = kernels.device_calls()
        row["device_crypto_seconds"] = kernels.device_seconds()
        row["armed_device"] = kernels.armed_device().type
    # every grid_validate_sum call of a miner's fold launches B2 once
    # (prewarm's launches are on top: it runs under the same switch)
    row["b2_fold_launches"] = row["device_crypto_calls"].get(
        "grid_validate", 0)
    row["b3_round_launches"] = {k: v - peers * prewarm_b3[k]
                                for k, v in row["b3_launches"].items()}
    return row


def armed_launch_gates(row: dict) -> None:
    """An armed run launched B2 in its miners' folds and B3a, B3c and B3d
    in its rounds, on the card."""
    if not (row["b2_fold_launches"] >= 1
            and row["b2_launches"] >= row["b2_fold_launches"]
            and row["armed_device"] == "cuda"):
        raise AssertionError(f"live {row['cluster']} did not run B2 in its "
                             f"miners' folds on the card: {row}")
    if min(row["b3_round_launches"][k] for k in
           ("msm_ladder", "grid_validate_points", "point_add")) < 1:
        raise AssertionError(f"live {row['cluster']}'s rounds did not launch "
                             f"B3a, B3c and B3d: {row['b3_round_launches']}")


def armed_pair(name: str, witness: str, ports: tuple, prewarm_b3: dict,
               budget: int, checks=None, peers: int = LIVE_PEERS,
               phase: str = "live", gates=None, timeouts=None,
               **kw) -> tuple:
    """(witness, armed): a cluster of `peers` run on the native host
    plane and then armed (armed_cluster), pair after pair until a pair
    pooled the same workers in every round, up to `budget` pairs; both
    runs take `timeouts` where given (else LIVE_FAST and LIVE_ARMED). A
    verifier pools the first krum_update_thresh updates to arrive (the
    reference's main.go:680-684, ROADMAP C8), so two runs of one cluster,
    on either plane, can pool other workers. Every armed run is held to
    `gates` (armed_launch_gates unless given) and `checks(row)`, which
    need no witness; `phase` labels the rows. Both
    planes draw from one seed and decide only which commitments and grids
    pass, so on the same pools the chains must agree hash for hash: a
    plane that refused a valid grid, or passed everything, would part
    them."""
    for pair in range(budget):
        w = live_cluster(witness, ports[0], timeouts or LIVE_FAST, peers, **kw)
        emit(phase, pair=pair, **w)
        row = armed_cluster(name, ports[1], prewarm_b3, peers,
                            timeouts or LIVE_ARMED, **kw)
        row["pair"] = pair
        row["pools_equal_witness"] = pooled(row) == pooled(w)
        row["chain_equals_witness"] = row["chain"] == w["chain"]
        emit(phase, **row)
        (gates or armed_launch_gates)(row)
        if checks:
            checks(row)
        if row["pools_equal_witness"]:
            break
    if not row["pools_equal_witness"]:
        raise AssertionError(f"live {name} and its witness pooled other "
                             f"workers in each of {budget} pairs: "
                             f"{row['pools']} vs {w['pools']}")
    if not row["chain_equals_witness"]:
        raise AssertionError(
            f"live {name}'s chain is not its native witness's: "
            f"{row['chain']} vs {w['chain']}; pools {row['pools']} vs "
            f"{w['pools']}; contributors {row['block_sources']} vs "
            f"{w['block_sources']}")
    return w, row


def offender_gates(row: dict, offenders) -> None:
    """The honest majority's verdicts on the Byzantine peers: each
    offender rejected, never accepted and debited below its genesis
    stake, and some honest update in a block."""
    for sid in offenders:
        if not (sid in row["rejected"] and sid not in row["accepted"]
                and row["stake"][sid] < row["default_stake"]):
            raise AssertionError(f"live {row['cluster']}: offender {sid} was "
                                 f"not rejected and debited: {row}")
    if not row["accepted"]:
        raise AssertionError(f"live {row['cluster']}: no honest update "
                             f"entered a block: {row}")


def witness_gates(row: dict, witness: dict) -> None:
    """The accepted and rejected ids, the stake map and the chain the
    native witness's."""
    for key in ("accepted", "rejected", "stake", "chain"):
        if row[key] != witness[key]:
            raise AssertionError(f"live {row['cluster']}: {key} "
                                 f"{row[key]} is not its native witness's "
                                 f"{witness[key]}")


def live_byzantine(prewarm_b3: dict) -> dict:
    """live (d) and (e): armed Byzantine clusters on the card, each held to
    a native-plane witness of the same classes and seed. Returns their
    rows, B2's launches and B3's round launches (beyond the prewarms)."""
    from biscotti_tpu_torch.config import Defense

    cls = byzantine_peers()
    # (d): 7 peers, secure aggregation, noising and verification with no
    # defense, so the miners' crypto and not Krum must catch two of round
    # 0's workers; pipelined rounds with speculation and batched intake.
    # Every armed run is held to the offenders' verdicts and a clean
    # speculation plane; the pair that pooled alike to its witness.
    workers, _ = round0_roles(LIVE_PEERS, 1, 7850)
    corrupt, forged = workers[-1], workers[-2]
    d_classes = {corrupt: cls["CorruptSharePeer"],
                 forged: cls["ForgedCommitmentPeer"]}

    def d_checks(row):
        offender_gates(row, (corrupt, forged))
        spec = row["counters"]
        if not (spec["speculation_ready"] > 0
                and spec["speculation_error"] == 0):
            raise AssertionError(f"live (d): speculation ready "
                                 f"{spec['speculation_ready']}, errors "
                                 f"{spec['speculation_error']}")

    dw, d = armed_pair("d_byzantine_armed_pipelined", "d_witness_native",
                       (LIVE_BASE_PORT + 40, LIVE_BASE_PORT + 50), prewarm_b3,
                       BYZANTINE_PAIRS, d_checks, dataset="mnist",
                       secure_agg=True, noising=True, verification=True,
                       epsilon=1.0, defense=Defense.NONE, max_iterations=3,
                       pipeline=True, speculation=True, batch_intake=True,
                       classes=d_classes)
    witness_gates(d, dw)
    # (e): the reference's colluding cancellation (test_byzantine.py:171-
    # 228): 7 peers, 2 miners, one round; colluders B (+e) and C (-e)
    # cancel inside every miner's intake batch, the non-leader miner lies
    # C out of the agreed set, and the leader's aggregation-boundary
    # re-check must isolate B. Every worker is pooled (4 workers), so
    # the pools, and with them the chain, are the witness's on any run.
    workers, miners = round0_roles(LIVE_PEERS, 2, 7850)
    plus, minus, liar = workers[0], workers[1], min(miners)
    cls["LyingListMiner"].OMIT = minus
    e_classes = {plus: cls["PlusSharePeer"], minus: cls["MinusSharePeer"],
                 liar: cls["LyingListMiner"]}
    e_kw = dict(dataset="mnist", secure_agg=True, verification=True,
                defense=Defense.NONE, max_iterations=1, num_miners=2,
                classes=e_classes)
    ew = live_cluster("e_witness_native", LIVE_BASE_PORT + 60, LIVE_FAST,
                      LIVE_PEERS, **e_kw)
    emit("live", **ew)
    with IntakeVerdicts() as intake:
        e = armed_cluster("e_colluders_armed", LIVE_BASE_PORT + 70,
                          prewarm_b3, LIVE_PEERS, **e_kw)
    # each intake call of the armed run, computed again on the native
    # plane from the same instances: the cancelled batch must pass on
    # both, the boundary's partial batch and B's single fail on both
    e["intake_verdicts"] = intake.verdicts()
    e["intake_verdicts_native"] = intake.replay()
    e["pools_equal_witness"] = pooled(e) == pooled(ew)
    emit("live", **e)
    if not (e["intake_verdicts"] == e["intake_verdicts_native"]
            and any(n >= 2 and ok for n, ok in e["intake_verdicts"])
            and any(not ok for _, ok in e["intake_verdicts"])):
        raise AssertionError(f"live (e): the device's intake verdicts "
                             f"{e['intake_verdicts']} are not the native "
                             f"plane's {e['intake_verdicts_native']} on the "
                             f"same instances")
    offender_gates(e, (plus,))
    if not e["pools_equal_witness"]:
        raise AssertionError(f"live (e) pooled other workers than its "
                             f"witness: {e['pools']} vs {ew['pools']}")
    witness_gates(e, ew)
    if minus in e["accepted"] or not any(w in e["accepted"]
                                         for w in workers[2:]):
        raise AssertionError(f"live (e): the lied-out colluder entered the "
                             f"block, or no honest update did: {e}")
    return {"d": d, "e": e,
            "b2_launches": d["b2_launches"] + e["b2_launches"],
            "b3_launches": {k: d["b3_round_launches"][k]
                            + e["b3_round_launches"][k]
                            for k in d["b3_round_launches"]}}


def live_phase(prewarm_b3: dict) -> dict:
    """The live peer on the card: clusters (a), (b) with its witness and
    (c) of the module docstring, the verifier seam, and the armed
    Byzantine clusters (d) and (e) with their witnesses; returns the
    phase's row with B2's and B3's launches in (b), (d) and (e).
    `prewarm_b3` is one prewarm's B3 launches at this width (the secagg
    phase's), which every armed peer makes before its first round; the
    round launches are those beyond them."""
    import torch

    t_phase = time.perf_counter()
    secagg = dict(dataset="mnist", secure_agg=True, noising=True,
                  verification=True, epsilon=1.0)
    a = live_cluster("a_secagg_native", LIVE_BASE_PORT, LIVE_FAST, LIVE_PEERS,
                     max_iterations=3, **secagg)
    emit("live", **a)
    # (b): the armed plane, whose ladders are kernel B3 since it replaced
    # the eager ones (1e5 launches an msm, a 105 s round at 4 peers), held
    # to its witness on the native host plane
    _, b = armed_pair("b_secagg_device_crypto", "b_witness_native",
                      (LIVE_BASE_PORT + 30, LIVE_BASE_PORT + 10), prewarm_b3,
                      LIVE_PAIRS, max_iterations=3, batch_intake=True,
                      **secagg)
    c = live_cluster("c_cnn_plain", LIVE_BASE_PORT + 20, LIVE_FAST, LIVE_PEERS,
                     max_iterations=2, dataset="mnist", model_name="mnist_cnn",
                     secure_agg=False, noising=False, verification=True)
    emit("live", **c)
    seam = live_seam()
    emit("live", cluster="verifier_seam", **seam)
    byz = live_byzantine(prewarm_b3)
    torch.cuda.synchronize()
    return {"b2_launches": b["b2_launches"] + byz["b2_launches"],
            "b2_launches_by_cluster": {"b": b["b2_launches"],
                                       "d": byz["d"]["b2_launches"],
                                       "e": byz["e"]["b2_launches"]},
            "b3_launches": {k: v + byz["b3_launches"][k]
                            for k, v in b["b3_round_launches"].items()},
            "b3_launches_by_cluster": {
                "b": b["b3_round_launches"],
                "d": byz["d"]["b3_round_launches"],
                "e": byz["e"]["b3_round_launches"]},
            "seconds": time.perf_counter() - t_phase}


class PeerRecorder:
    """Every PeerAgent built while it is entered, incarnations included:
    the chaos CLI imports the class when it runs, so a subclass put in its
    module's place records each agent the CLI makes. Each agent keeps, in
    `opened`, one [peer, streak] a breaker open: the failures that opened
    it, each [msg_type, attempt, the fault the plan drew for that attempt,
    the error, whether the peer's newest incarnation still served]. A
    call draws its fault in its own task just before it fails, so the
    task's last draw is the failed attempt's. `modules` are the drivers
    that bound the class at their import (`eval_attack_matrix`): their
    `PeerAgent` is swapped too."""

    def __init__(self, *modules):
        self.modules = modules

    def __enter__(self):
        import asyncio
        import weakref

        from biscotti_tpu_torch.runtime import peer

        self.mod, self.orig, self.agents = peer, peer.PeerAgent, []
        made = self.agents

        class Recorded(peer.PeerAgent):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.drawn = weakref.WeakKeyDictionary()
                self.streaks, self.opened = {}, []
                inj = self.pool.faults
                if inj is not None:
                    draw, drawn = inj.action, self.drawn

                    def action(host, port, msg_type, attempt=0):
                        act = draw(host, port, msg_type, attempt)
                        drawn[asyncio.current_task()] = [msg_type, attempt,
                                                         act.kind()]
                        return act

                    inj.action = action
                made.append(self)

            def _record_peer_ok(self, peer_id):
                self.streaks.pop(peer_id, None)
                super()._record_peer_ok(peer_id)

            def _record_peer_fail(self, peer_id):
                err = sys.exc_info()[1]
                dst = [a.server._server for a in made if a.id == peer_id]
                self.streaks.setdefault(peer_id, []).append(
                    self.drawn.get(asyncio.current_task(),
                                   [None, None, "none"])
                    + [type(err).__name__,
                       bool(dst and dst[-1] and dst[-1].is_serving())])
                opens = self.counters.get("breaker_open", 0)
                super()._record_peer_fail(peer_id)
                if self.counters.get("breaker_open", 0) > opens:
                    self.opened.append([peer_id, self.streaks.pop(peer_id)])

        self.bound = [(m, m.PeerAgent) for m in self.modules]
        for m in (peer, *self.modules):
            m.PeerAgent = Recorded
        return self

    def __exit__(self, *exc):
        self.mod.PeerAgent = self.orig
        for m, cls in self.bound:
            m.PeerAgent = cls


def chaos_cell(name: str, nodes: int, flags: list, prewarm_b3: dict) -> tuple:
    """One run of `biscotti_tpu_torch.tools.chaos.main` on the card at the
    live width, under BISCOTTI_PALLAS_CRYPTO=1 with the B2 and B3 counters
    at 0: (its row, its report, every agent it built)."""
    import io

    from biscotti_tpu_torch.crypto import kernels
    from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv
    from biscotti_tpu_torch.tools import chaos

    port = free_base(CHAOS_BASE_PORT, nodes)
    argv = ["--nodes", str(nodes), "--dataset", "mnist", "--device", "cuda",
            "--base-port", str(port)] + flags
    out = io.StringIO()
    t0 = time.perf_counter()
    with crypto_switch(), PeerRecorder() as rec, \
            contextlib.redirect_stdout(out):
        rc = chaos.main(argv)
        b2 = cv.oncurve_mask.launches
        b3 = cl.launches()
        calls = kernels.device_calls()
    wall_s = time.perf_counter() - t0
    report = json.loads(out.getvalue())
    armed = "--device-crypto" in flags
    row = {"cell": name, "argv": argv, "rc": rc, "wall_s": wall_s,
           "rounds": report["rounds"], "agents": len(rec.agents),
           "devices": sorted({(a.device.type, str(a.trainer.x_test.device))
                              for a in rec.agents}),
           "b2_launches": b2, "b2_fold_launches": calls.get("grid_validate", 0),
           "b3_launches": b3,
           # every armed peer prewarms once before its first round
           "b3_round_launches": {k: v - (nodes * prewarm_b3[k] if armed else 0)
                                 for k, v in b3.items()},
           **{k: report[k] for k in (
               "settled_prefix_equal", "settled_height", "real_blocks",
               "faults_injected", "rpc_retries", "breaker_opens", "sheds",
               "admission_enabled", "flood", "device_crypto", "churn",
               "campaign", "defense_verdict")}}
    if row["devices"] != [("cuda", "cuda:0")]:
        raise AssertionError(f"chaos {name} left the card: {row}")
    return row, report, rec.agents


def elected_miners(anchor) -> dict:
    """Each settled round's miner committee, re-derived from `anchor`'s
    chain by the election every peer runs."""
    from biscotti_tpu_torch.parallel import roles

    c, chain, out = anchor.cfg, anchor.chain, {}
    for blk in chain.blocks[1:]:
        prev = chain.get_block(blk.iteration - 1)
        if prev is not None:
            _, miners = roles.elect_committees(
                dict(prev.stake_map), prev.hash, c.num_verifiers,
                c.num_miners, c.num_nodes)
            out[blk.iteration] = sorted(miners)
    return out


def chaos_faults_overload(prewarm_b3: dict) -> dict:
    """chaos (a) of the module docstring: its row, gated."""
    from biscotti_tpu_torch.tools.chaos import chain_oracle

    row, report, agents = chaos_cell("a_faults_overload_armed", 7,
                                     CHAOS_A_FLAGS, prewarm_b3)
    flooder = int(report["flood"]["node"])
    honest = [n for n in report["per_node"] if n["node"] != flooder]
    # ROADMAP C12: the flooder's own calls resolve on a shed replay's busy
    # reply, so at this width it cannot fetch a block and mints its own
    # empty ones; the protocol's promise is the honest peers' prefix
    equal, height, real = chain_oracle(
        [{"chain_dump": a.chain.dump()} for a in agents if a.id != flooder])
    block_s = agents[0].timeouts.block_s
    row.update(
        honest_prefix_equal=equal, honest_height=height, honest_real=real,
        flooder_counters={k: v for a in agents if a.id == flooder
                          for k, v in sorted(a.counters.items())
                          if k.startswith(("rpc_busy", "breaker", "block_",
                                           "round_stall"))},
        honest_shed_total=sum(n["admission"]["shed_total"] for n in honest),
        peaks=[[n["node"], n["admission"]["inflight_peak"],
                n["admission"]["caps"]["global_inflight"],
                n["admission"]["parked_peak"],
                n["admission"]["caps"]["max_parked"]]
               for n in report["per_node"]],
        # every open between honest peers, with the streak that opened it
        honest_breaker_opens=[[a.id, pid, streak] for a in agents
                              if a.id != flooder
                              for pid, streak in a.opened if pid != flooder],
        wall_bound_s=CHAOS_CELL_S + CHAOS_A_STALLS * block_s)
    emit("chaos", **row)
    if not (equal and height >= 2 and real >= 1):
        raise AssertionError(f"chaos (a): the honest peers' settled prefixes "
                             f"differ, reach no height 2 or hold no real "
                             f"block: {row}")
    if not (row["faults_injected"].get("flood", 0)
            and row["honest_shed_total"] > 0):
        raise AssertionError(f"chaos (a): no flood or no honest shed: {row}")
    if not all(inf <= inf_cap and park <= max(1, park_cap)
               for _, inf, inf_cap, park, park_cap in row["peaks"]):
        raise AssertionError(f"chaos (a): a peak over its cap: {row['peaks']}")
    # the breaker counts a dropped frame's timed-out call and a call to a
    # peer that has ended its run and closed its server; BusyError, the
    # overload's answer, never counts, and no other failure may open a
    # breaker between honest peers
    if not all((kind == "drop" and err == "TimeoutError") or not serving
               for *_, streak in row["honest_breaker_opens"]
               for _, _, kind, err, serving in streak):
        raise AssertionError(f"chaos (a): a breaker opened between honest "
                             f"peers on a failure that is neither a dropped "
                             f"frame nor a peer gone: "
                             f"{row['honest_breaker_opens']}")
    if row["device_crypto"]["path"] != "device" or min(
            row["b3_round_launches"][k]
            for k in ("msm_ladder", "point_add")) < 1:
        raise AssertionError(f"chaos (a) did not run the plane on the card "
                             f"(B3a and B3d in its rounds): {row}")
    if row["wall_s"] > row["wall_bound_s"]:
        raise AssertionError(f"chaos (a) took {row['wall_s']:.1f} s, over "
                             f"its {row['wall_bound_s']:.0f} s: {row}")
    return row


def chaos_churn(prewarm_b3: dict) -> dict:
    """chaos (b) of the module docstring: its row, gated."""
    from biscotti_tpu_torch.runtime.faults import FaultPlan

    row, report, _ = chaos_cell("b_churn", 5, CHAOS_B_FLAGS, prewarm_b3)
    churn = report["churn"]
    row["churn_schedule"] = [[e.round, e.node, e.kind] for e in FaultPlan(
        seed=CHAOS_CHURN_SEED, churn=churn["fraction"],
        churn_period=churn["period"], churn_down=churn["down"],
    ).churn_schedule(5, report["rounds"])]
    row["member_join"] = report["cluster"]["counters"].get("member_join", 0)
    emit("chaos", **row)
    applied = churn["events_applied"]
    if row["rc"] != 0 or row["wall_s"] > CHAOS_CELL_S:
        raise AssertionError(f"chaos (b): rc {row['rc']} (the surviving-"
                             f"prefix oracle) in {row['wall_s']:.1f} s, over "
                             f"{CHAOS_CELL_S} s or failed: {row}")
    if not applied or applied != row["churn_schedule"][:len(applied)] \
            or row["member_join"] < 1:
        raise AssertionError(f"chaos (b): the applied events are no prefix of "
                             f"the schedule, or no join was seen: {row}")
    return row


def chaos_campaign(prewarm_b3: dict) -> dict:
    """chaos (c) of the module docstring: its row, gated."""
    row, _, agents = chaos_cell("c_campaign_roleflood", 7, CHAOS_C_FLAGS,
                                prewarm_b3)
    elected = elected_miners(next(a for a in agents if a.id == 0))
    checked, targets = [], {}
    for a in agents:
        if a.campaign is None:
            continue
        logged = {e[0]: e[2] for e in a.campaign.schedule if e[1] == "target"}
        targets[a.id] = logged
        checked += [[a.id, it, logged[it], miners]
                    for it, miners in elected.items()
                    if it in logged and a.id not in miners]
    row.update(flood_targets=targets, targets_vs_elected=checked)
    emit("chaos", **row)
    if row["rc"] != 0 or row["wall_s"] > CHAOS_CELL_S:
        raise AssertionError(f"chaos (c): rc {row['rc']} in "
                             f"{row['wall_s']:.1f} s, over {CHAOS_CELL_S} s "
                             f"or failed: {row}")
    if not (sum(row["campaign"]["actions"].values()) > 0 and checked
            and row["defense_verdict"]
            and all(t == m for _, _, t, m in checked)):
        raise AssertionError(f"chaos (c): no action, a flood target off the "
                             f"elected committee or no verdict: {row}")
    return row


def chaos_phase(prewarm_b3: dict) -> dict:
    """The chaos CLI on the card, cells (a)-(c) of the module docstring;
    returns the phase's row with (a)'s B2 and B3 launches."""
    import torch

    t_phase = time.perf_counter()
    a = chaos_faults_overload(prewarm_b3)
    chaos_churn(prewarm_b3)
    chaos_campaign(prewarm_b3)
    torch.cuda.synchronize()
    return {"b2_launches": a["b2_launches"],
            "b3_launches": a["b3_round_launches"],
            "seconds": time.perf_counter() - t_phase}


class KernelInputs:
    """The largest input each kernel got on the card while this is entered,
    cloned, so the phase can time the kernels at the main path's own shapes
    after the run: B2's cells (`cuda_validate._launch`), B3a's lanes, B3b's
    bits and table (keyed by the table's rows: 256 for B or H, 512 for the
    Pedersen comb's B‖H), B3c's grid cells (`cuda_ladder._launch`) and the
    points of B3d's trees over one column, the msm's (`_counted_tree`).
    Only the module-level launchers are swapped; the counting wrappers run
    as before."""

    def __enter__(self):
        from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
        from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv

        self.seen: dict = {}
        self.swapped = [(cv, "_launch", cv._launch),
                        (cl, "_launch", cl._launch),
                        (cl, "_counted_tree", cl._counted_tree)]

        def keep(key, *ts):
            # the latest of the largest: a round's call, not the prewarm's
            if ts[0].is_cuda and ts[0].numel() >= self.seen.get(key, (0,))[0]:
                self.seen[key] = (ts[0].numel(), [t.clone() for t in ts])

        def b2(xy, *a, **k):
            keep("B2", xy)
            return self.swapped[0][2](xy, *a, **k)

        def b3(wrapper, entry, args, *a, **k):
            if entry == "ed25519_msm_ladder":
                keep("B3a", args[0], args[2])
            elif entry == "ed25519_fixed_walk":
                keep(f"B3b/{args[2].shape[0]}", args[0], args[2])
            elif entry == "ed25519_grid_points" and args[2] is None:
                keep("B3c", args[0])
            return self.swapped[1][2](wrapper, entry, args, *a, **k)

        def tree(name, src, rows, cols, *a, **k):
            if cols == 1:  # column_sum's [rows, 1, 4, 16] view of the points
                keep("B3d", src.reshape(rows, *src.shape[-2:]))
            return self.swapped[2][2](name, src, rows, cols, *a, **k)

        cv._launch, cl._launch, cl._counted_tree = b2, b3, tree
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.swapped:
            setattr(mod, name, fn)

    def get(self, key: str) -> list:
        if key not in self.seen:
            raise AssertionError(f"protocol: no {key} launch was recorded "
                                 f"on the card ({sorted(self.seen)})")
        return self.seen[key][1]


def protocol_rows(dev, ladder: dict, mix, cnn: KernelInputs,
                  keyed: KernelInputs) -> dict:
    """B2, B3a, B3c and B3d at the shapes (a)'s armed rounds gave them (the
    fold's cells at the cifar_cnn width, its settle's msm lanes and their
    tree), B3b at (b)'s keyed settle's Pedersen comb: each against its
    plain version (bit for bit), through its wrapper and alone (CUDA
    events, median of 20) and plain (one call: the plain ladders take
    seconds at these widths), beside its bound. Launches made here are
    comparisons, not main-path launches. Returns {id: row}."""
    import torch

    from biscotti_tpu_torch import _build
    from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv

    lib = _build.load("ed25519_ladder")
    stream = torch.cuda.current_stream().cuda_stream
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    lay = ladder["layout"]
    rows: dict = {}

    # B2: the fold's on-curve cells
    (xy,) = cnn.get("B2")
    n = len(xy)
    got, want = cv.oncurve_mask(xy), cv.oncurve_mask_plain(xy)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    olib = _build.load("oncurve")
    bound_ms, bound_by, _ = oncurve_bound(n, mix)
    r = {"kernel": "B2", "shape": [n], "mismatches": int((got != want).sum()),
         "max_abs_err": float((got.int() - want.int()).abs().max()),
         "ms": time_ms(lambda: cv.oncurve_mask(xy)),
         "kernel_only_ms": time_ms(lambda: olib.oncurve_mask_i64(
             xy.data_ptr(), out.data_ptr(), flag.data_ptr(), n, stream)),
         "plain_ms": once_ms(lambda: cv.oncurve_mask_plain(xy)),
         "bound_ms": bound_ms, "bound_by": bound_by}
    emit("protocol", **r)
    rows["B2"] = [r]
    if r["mismatches"] or int(flag):
        raise AssertionError(f"B2 at the cifar_cnn fold's {n} cells: {r}")

    # B3a: the settle's msm lanes
    bits, pts = cnn.get("B3a")
    m, words = bits.shape
    out = torch.empty_like(pts)
    lanes = cl.msm_ladder(bits, pts)
    want = cl.msm_ladder_plain(bits, pts)
    ladder_record(rows, "protocol", ladder, flag, "B3a", [m, 32 * words],
                  (lanes,), (want,), lambda: cl.msm_ladder(bits, pts),
                  lambda: lib.ed25519_msm_ladder(
                      bits.data_ptr(), words, pts.data_ptr(), out.data_ptr(),
                      flag.data_ptr(), m, stream),
                  lambda: once_ms(lambda: cl.msm_ladder_plain(bits, pts)),
                  {**msm_ladder_bound(bits.cpu().numpy(),
                                      bits.nbytes + 2 * pts.nbytes, lay),
                   "threads_a_lane": lay["kMsmGroup"]})

    # B3d: the tree over those lanes
    (src,) = cnn.get("B3d")
    m = len(src)
    ladder_record(rows, "protocol", ladder, flag, "B3d", ["tree", m],
                  (cl.tree_sum(src),), (cl.column_tree_plain(src),),
                  lambda: cl.tree_sum(src),
                  lambda: cl.tree_launches(lib, src, m, 1, flag, stream),
                  lambda: once_ms(lambda: cl.column_tree_plain(src)),
                  {**tree_bound(m, 1, (m + 1) * 4 * 16 * 8, lay),
                   "threads_a_lane": lay["kAddGroup"]})

    # B3c: the fold's grid verdicts (grid_sum's instance)
    (xy,) = cnn.get("B3c")
    w, ncol = xy.shape[:2]
    ok = torch.empty((w, ncol), dtype=torch.bool, device=dev)
    report = ladder["ptxas"]["B3c"].get("instances", {})
    report = next((r for k, r in report.items() if "ILb0E" in k), {})
    ladder_record(rows, "protocol", ladder, flag, "B3c", [w, ncol],
                  (cl.grid_verdicts(xy),), (cl.grid_verdicts_plain(xy),),
                  lambda: cl.grid_verdicts(xy),
                  lambda: lib.ed25519_grid_points(
                      xy.data_ptr(), ok.data_ptr(), None, flag.data_ptr(),
                      w * ncol, stream),
                  lambda: once_ms(lambda: cl.grid_verdicts_plain(xy)),
                  {**grid_cell_bound(w * ncol, False),
                   "threads_a_cell": 1}, report=report)

    # B3b: the keyed settle's Pedersen comb on B‖H
    bits, table = keyed.get("B3b/512")
    m, words = bits.shape
    out = torch.empty((m, 4, 16), dtype=torch.int64, device=dev)
    ladder_record(rows, "protocol", ladder, flag, "B3b", [m, 32 * words],
                  (cl.fixed_walk(bits, table),),
                  (cl.fixed_walk_plain(bits, table),),
                  lambda: cl.fixed_walk(bits, table),
                  lambda: lib.ed25519_fixed_walk(
                      bits.data_ptr(), words, table.data_ptr(),
                      out.data_ptr(), flag.data_ptr(), m, stream),
                  lambda: once_ms(lambda: cl.fixed_walk_plain(bits, table)),
                  {**fixed_walk_bound(bits.cpu().numpy(),
                                      bits.nbytes + table.nbytes + out.nbytes,
                                      lay),
                   "threads_a_lane": 4 * lay["kWalkGroup"]})
    return {k: v[0] for k, v in rows.items()}


def keyed_ladders(dev, key_dir: str) -> dict:
    """B3a on the msm of a keyed commitment, Σ qᵢ·Gᵢ over the transcript-
    derived generators of `key_dir`'s commit key at seeded quantized
    entries, and B3b on H's table at scalars drawn from the transcript,
    each bit for bit against its plain version; the device's commitment
    is the native plane's (`commit_update`). Comparisons, not main-path
    launches."""
    import hashlib

    import torch

    from biscotti_tpu_torch.crypto import commitments as cm
    from biscotti_tpu_torch.crypto import ed25519 as ed
    from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
    from biscotti_tpu_torch.crypto.kernels import group as gp
    from biscotti_tpu_torch.crypto.kernels import primitives as prim

    with open(os.path.join(key_dir, "commit_key.json")) as f:
        key = cm.CommitKey.deserialize(json.load(f)["points"])
    with open(os.path.join(key_dir, "genesis.json")) as f:
        transcript = bytes.fromhex(json.load(f)["transcript"])
    q = np.random.default_rng(0).integers(-3000, 3000, len(key.points))
    bits_np, pts_np = prim.msm_lanes([int(v) % ed.Q for v in q], key.points)
    bits, pts = (torch.from_numpy(a).to(dev) for a in (bits_np, pts_np))
    lanes = cl.msm_ladder(bits, pts)
    msm_equal = torch.equal(lanes, cl.msm_ladder_plain(bits, pts))
    point = gp.limbs_to_point(cl.tree_sum(lanes).cpu().numpy())
    commitment_equal = ed.point_compress(point) == cm.commit_update(q, key)
    scalars = [int.from_bytes(hashlib.sha512(transcript + bytes([i])).digest(),
                              "little") % ed.Q for i in range(4)]
    fbits = torch.from_numpy(prim.fixed_lanes(scalars)).to(dev)
    table = torch.from_numpy(prim._fixed_table("H")).to(dev)
    walk_equal = torch.equal(cl.fixed_walk(fbits, table),
                             cl.fixed_walk_plain(fbits, table))
    row = {"generators": len(key.points), "msm_lanes": len(bits),
           "b3a_equals_plain": msm_equal,
           "commitment_equals_native": commitment_equal,
           "b3b_lanes": len(fbits), "b3b_equals_plain": walk_equal}
    emit("protocol", cell="keyed_ladders", **row)
    if not (msm_equal and commitment_equal and walk_equal):
        raise AssertionError(f"protocol (b): the keyed ladders are not their "
                             f"plain versions: {row}")
    return row


def warm_cell(cfg) -> None:
    """One step and one test error of a throwaway Trainer of `cfg`'s model
    on the card, and one native VSS commitment at its width: a cluster's
    first round must not absorb them."""
    from biscotti_tpu_torch.crypto import commitments as cm
    from biscotti_tpu_torch.models.trainer import Trainer
    from biscotti_tpu_torch.ops import secretshare as ss

    t = Trainer(cfg.dataset, f"{cfg.dataset}0", cfg=cfg, seed=0)
    w = np.zeros(t.num_params)
    t.private_fun(w, 0)
    t.test_error(w)
    c = ss.num_chunks(t.num_params, cfg.poly_size)
    cm.vss_commit_chunks_bytes(np.zeros((c, cfg.poly_size), np.int64),
                               bytes(32), b"warm")


def armed_walk_gates(row: dict) -> None:
    """armed_launch_gates, and B3b's launches beyond the prewarms too."""
    armed_launch_gates(row)
    if row["b3_round_launches"]["fixed_walk"] < 1:
        raise AssertionError(f"{row['cluster']}'s rounds did not launch "
                             f"B3b: {row['b3_round_launches']}")


def protocol_phase(dev, ladder: dict, mix, prewarm_b3: dict) -> dict:
    """The keyed and CNN-width secure-aggregation paths armed on the card,
    and the reference's codec acceptance, cells (a)-(c) of the module
    docstring; `prewarm_b3` is one prewarm's B3 launches at the mnist
    width (the secagg phase's), (a)'s is taken here at its own. Returns
    the phase's row with B2's and B3's launches and the kernels' rows at
    the new shapes."""
    import tempfile

    import torch

    from biscotti_tpu_torch.config import BiscottiConfig, Defense
    from biscotti_tpu_torch.crypto import kernels
    from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
    from biscotti_tpu_torch.ops import secretshare as ss
    from biscotti_tpu_torch.tools import keygen

    t_phase = time.perf_counter()
    # (a): 4 cifar_cnn peers at full width, the settings of the
    # reference's test_runtime.py:222 with pipelined rounds and batched
    # intake, so the miners' grid folds run B2 and B3c at this width
    t0 = time.perf_counter()
    poly = BiscottiConfig().poly_size
    ck = ss.num_chunks(PROTOCOL_CNN_PARAMS, poly) * poly  # the peers' prewarm
    with crypto_switch(arm=True):
        kernels.prewarm(ck)
        prewarm_cnn = cl.launches()
    # a process's first cifar_cnn step and first native commitment at this
    # width, outside the witness's first round window
    warm_cell(BiscottiConfig(dataset="cifar", model_name="cifar_cnn",
                             batch_size=4))
    a_kw = dict(dataset="cifar", model_name="cifar_cnn", secure_agg=True,
                verification=True, defense=Defense.NONE, batch_size=4,
                pipeline=True, batch_intake=True,
                max_iterations=PROTOCOL_ROUNDS, peers=PROTOCOL_PEERS)
    with KernelInputs() as cnn_inputs:
        aw, a = armed_pair("a_cnn_secagg_armed", "a_cnn_witness_native",
                           (PROTOCOL_BASE_PORT, PROTOCOL_BASE_PORT + 10),
                           prewarm_cnn, PROTOCOL_PAIRS, armed_walk_gates,
                           phase="protocol", **a_kw)
    witness_gates(a, aw)
    if a["params"] != PROTOCOL_CNN_PARAMS:
        raise AssertionError(f"protocol (a) ran {a['params']} parameters")
    a["seconds"] = time.perf_counter() - t0
    emit("protocol", cell="cnn_secagg", params=a["params"],
         b2_fold_launches=a["b2_fold_launches"],
         b3_round_launches=a["b3_round_launches"],
         b3_prewarm=prewarm_cnn, seconds=a["seconds"])

    # (b): 4 peers keyed by the dealerless genesis at the mnist width
    t0 = time.perf_counter()
    key_dir = tempfile.mkdtemp(prefix="protocol_keys_")
    keygen.generate_dkg(dims=PROTOCOL_KEYED_PARAMS, nodes=PROTOCOL_PEERS,
                        out_dir=key_dir, rng_seed=PROTOCOL_KEY_SEED)
    keyed = keyed_ladders(dev, key_dir)

    def b_checks(row):
        # the one-shot intake (no batch_intake, as the reference's cluster)
        # folds no grid: B2 runs in the prewarms only, B3c not at all
        if not (row["armed_device"] == "cuda" and min(
                row["b3_round_launches"][k] for k in
                ("msm_ladder", "fixed_walk", "point_add")) >= 1):
            raise AssertionError(f"protocol (b)'s rounds did not launch B3a, "
                                 f"B3b and B3d on the card: {row}")
        if not (row["rejected"] == [] and row["accepted"]
                and row["commitment_lengths"] == [32]
                and row["keyed_peers"] == PROTOCOL_PEERS
                and row["counters"]["submission_rejected"] == 0):
            raise AssertionError(f"protocol (b): a keyed run rejected, "
                                 f"minted nothing or ran unkeyed: {row}")

    with KernelInputs() as keyed_inputs:
        bw, b = armed_pair("b_dkg_keyed_armed", "b_dkg_witness_native",
                           (PROTOCOL_BASE_PORT + 20, PROTOCOL_BASE_PORT + 30),
                           prewarm_b3, PROTOCOL_PAIRS, gates=b_checks,
                           phase="protocol", peers=PROTOCOL_PEERS,
                           agent_kw={"key_dir": key_dir}, dataset="mnist",
                           secure_agg=True, verification=True,
                           max_iterations=PROTOCOL_ROUNDS)
    witness_gates(b, bw)
    b["seconds"] = time.perf_counter() - t0
    emit("protocol", cell="dkg_keyed", keyed=keyed,
         b2_fold_launches=b["b2_fold_launches"],
         b3_round_launches=b["b3_round_launches"], seconds=b["seconds"])

    # (c): the reference's codec acceptance (test_wire_codecs.py:346)
    # with the Trainers on the card and the native crypto plane
    t0 = time.perf_counter()
    warm_cell(BiscottiConfig(dataset="mnist", model_name="mnist_cnn"))
    c = {}
    for k, codec in enumerate(PROTOCOL_CODECS):
        c[codec] = live_cluster(
            f"c_codecs_{codec}", PROTOCOL_BASE_PORT + 40 + 10 * k, LIVE_FAST,
            PROTOCOL_PEERS, dataset="mnist", model_name="mnist_cnn",
            secure_agg=True, noising=False, verification=True, batch_size=8,
            seed=3, wire_codec=codec, max_iterations=PROTOCOL_ROUNDS)
        emit("protocol", **c[codec])
    per_round = {codec: sum(r["gossip_bytes_out"].values()) / r["rounds"]
                 for codec, r in c.items()}
    errors = {codec: r["final_error"] for codec, r in c.items()}
    ratio = per_round["raw64"] / per_round["f32+zlib"]
    codecs_row = {"cell": "codecs", "params": c["raw64"]["params"],
                  "gossip_bytes_per_round": per_round, "ratio": ratio,
                  "reference_bar": PROTOCOL_GOSSIP_X, "final_error": errors,
                  "seconds": time.perf_counter() - t0}
    emit("protocol", **codecs_row)
    for codec, r in c.items():
        if r["counters"]["submission_rejected"] \
                or not r["counters"]["secret_registered"]:
            raise AssertionError(f"protocol (c) {codec}: a submission was "
                                 f"rejected or no secret registered: {r}")
    if not ratio >= PROTOCOL_GOSSIP_X:
        raise AssertionError(f"protocol (c): f32+zlib sent {ratio:.2f}x fewer "
                             f"gossip bytes a round than raw64, not "
                             f"{PROTOCOL_GOSSIP_X}x: {per_round}")
    if abs(errors["raw64"] - errors["f32+zlib"]) > 0.2:
        raise AssertionError(f"protocol (c): final errors part: {errors}")

    shapes = protocol_rows(dev, ladder, mix, cnn_inputs, keyed_inputs)
    torch.cuda.synchronize()
    emit("protocol", cell="phase", seconds=time.perf_counter() - t_phase,
         cells_s={"a": a["seconds"], "b": b["seconds"],
                  "c": codecs_row["seconds"]})
    return {"b2_launches": a["b2_launches"] + b["b2_launches"],
            "b2_launches_by_cell": {"a": a["b2_launches"],
                                    "b": b["b2_launches"]},
            "b3_launches": {k: a["b3_round_launches"][k]
                            + b["b3_round_launches"][k]
                            for k in a["b3_round_launches"]},
            "b3_launches_by_cell": {"a": a["b3_round_launches"],
                                    "b": b["b3_round_launches"]},
            "shapes": shapes, "gossip_ratio": ratio,
            "seconds": time.perf_counter() - t_phase}


def drill_cfg(i: int, n: int, port: int, drill: str, **kw):
    """The `_cfg` of the reference's drill files (one verifier, miner and
    noiser, every plane off, 2 rounds, every peer sampled, batch 8, seed
    3) at the mnist softmax width, with the drill's windows
    (ACCEPT_WINDOWS); `kw` the drill's own settings."""
    from biscotti_tpu_torch.config import BiscottiConfig, Timeouts

    base = dict(node_id=i, num_nodes=n, dataset="mnist", base_port=port,
                num_verifiers=1, num_miners=1, num_noisers=1,
                secure_agg=False, noising=False, verification=False,
                max_iterations=2, convergence_error=0.0, sample_percent=1.0,
                batch_size=8, seed=3,
                timeouts=Timeouts(**ACCEPT_WINDOWS[drill]))
    base.update(kw)
    return BiscottiConfig(**base)


def drill_cluster(cfgs, during=None) -> tuple:
    """Port PeerAgents of `cfgs` on the card (device None: the GPU) in one
    event loop, run to the end: (agents, results, the run's start on the
    wall clock, what `during(agents)` returned: a coroutine awaited beside
    the run, as a mid-run poller)."""
    import asyncio

    from biscotti_tpu_torch.runtime.peer import PeerAgent

    async def go():
        agents = [PeerAgent(c) for c in cfgs]
        run = asyncio.ensure_future(
            asyncio.gather(*(a.run() for a in agents)))
        side = await during(agents) if during is not None else None
        return agents, await run, side

    t_start = time.time()
    agents, results, side = asyncio.run(go())
    return agents, results, t_start, side


def kernel_launches() -> dict:
    """Every hand kernel's launch counter as it stands: B1, B2, B3a-B3d."""
    from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv
    from biscotti_tpu_torch.ops import krum_cuda

    b3 = cl.launches()
    return {"B1": krum_cuda.krum_scores_kernel.launches,
            "B2": cv.oncurve_mask.launches,
            **{kid: b3[wrapper] for kid, (_, wrapper, _) in LADDER.items()}}


def drill_line(cell: str, t0: float, t_start: float, stamps, before: dict,
               **fields) -> dict:
    """An acceptance cell's row: its seconds (from `t0`, perf_counter),
    each round's wall time (the gaps between the anchor's per-round log
    stamps, the first from `t_start` on the wall clock), the rounds the
    anchor logged, every hand kernel's launches since `before` and the
    cell's own `fields` (the oracle's values)."""
    after = kernel_launches()
    return {"cell": cell, "seconds": time.perf_counter() - t0,
            "round_wall_s": round_walls(t_start, stamps),
            "rounds": len(stamps),
            "launches": {k: after[k] - before[k] for k in after}, **fields}


def log_stamps(result: dict) -> list:
    """The wall-clock stamps of a run result's per-round log lines."""
    return [float(line.split(",")[2]) for line in result["logs"]]


def round_walls(t_start: float, stamps: list) -> list:
    """Each round's wall time: the gaps between per-round stamps, the
    first from `t_start`."""
    return [b - a for a, b in zip([t_start] + stamps, stamps)]


def summed_counters(results) -> dict:
    """Every counter of a cluster's run results, summed over its peers."""
    out: dict = {}
    for r in results:
        for k, v in r["counters"].items():
            out[k] = out.get(k, 0) + v
    return dict(sorted(out.items()))


def summed_phases(results) -> dict:
    """Each round phase's seconds of a cluster's run, summed over its
    peers, largest first."""
    out: dict = {}
    for r in results:
        for ph, v in r.get("phases", {}).items():
            out[ph] = out.get(ph, 0.0) + v["total_s"]
    return {k: round(v, 4) for k, v in sorted(out.items(),
                                              key=lambda kv: -kv[1])}


def round_events(agents, it: int, t_start: float) -> dict:
    """{event: [first, last, count]} of round `it` over `agents`' flight
    recorders, in seconds from `t_start`: when the peers started it, when
    refused workers sent their declines (`update_rejected`), approved
    ones their shares (`update_sent`, the miner's `secret_registered`),
    when its block was minted, fell back to an empty one, or was accepted
    (`block_accepted` at height `it`)."""
    out: dict = {}
    for a in agents:
        for ev in a.tele.recorder.tail(1 << 20):
            name = ev.get("event")
            if (ev.get("iter") == it and name in (
                    "round_start", "update_rejected", "update_sent",
                    "defense_decided", "secret_registered", "block_minted",
                    "round_stall", "block_timeout_empty_fallback")) or (
                    name == "block_accepted" and ev.get("height") == it):
                out.setdefault(name, []).append(ev["ts"] - t_start)
    return {k: [min(v), max(v), len(v)] for k, v in sorted(out.items())}


def counter_total(registry, name: str) -> float:
    """The sum of a counter family's series in a metrics registry."""
    fam = registry.snapshot().get(name) if registry is not None else None
    return sum(row["value"] for row in fam["series"]) if fam else 0.0


def acceptance_guard(prewarm_b3: dict) -> dict:
    """acceptance (a): the device cluster's bit-identity guard
    (test_crypto_kernels.py:618-700) armed on the card, held to its
    native run pair by pair until the two pooled alike (ROADMAP C8)."""
    from biscotti_tpu_torch.config import Defense

    t0, before = time.perf_counter(), kernel_launches()
    workers, _ = round0_roles(ACCEPT_GUARD_PEERS, 1, 7850)
    corrupter = workers[-1]  # the highest id off round 0's committees

    def checks(row):
        if not (row["rejection_evidence"] and corrupter in row["rejected"]
                and row["stake"][corrupter] < row["default_stake"]):
            raise AssertionError(f"acceptance (a): the share corrupter "
                                 f"{corrupter} was not rejected and debited, "
                                 f"or no evidence was recorded: {row}")

    gw, g = armed_pair(
        "a_guard_armed", "a_guard_native",
        (ACCEPT_BASE_PORT, ACCEPT_BASE_PORT + 10), prewarm_b3,
        ACCEPT_GUARD_PAIRS, checks, peers=ACCEPT_GUARD_PEERS,
        phase="acceptance", gates=armed_walk_gates,
        timeouts=ACCEPT_WINDOWS["guard"], dataset="mnist", secure_agg=True,
        noising=False, verification=True, defense=Defense.NONE,
        max_iterations=1, batch_size=8, seed=3, pipeline=True,
        batch_intake=True,
        classes={corrupter: byzantine_peers()["CorruptSharePeer"]})
    row = {"cell": "a_guard", "seconds": time.perf_counter() - t0,
           "round_wall_s": g["round_wall_s"], "rounds": g["rounds"],
           "launches": {"B1": kernel_launches()["B1"] - before["B1"],
                        "B2": g["b2_launches"],
                        **{kid: g["b3_round_launches"][wrapper]
                           for kid, (_, wrapper, _) in LADDER.items()}},
           "b2_fold_launches": g["b2_fold_launches"],
           "b3_launches_with_prewarms": g["b3_launches"],
           "pairs": g["pair"] + 1, "corrupter": corrupter,
           "real_blocks": g["nonempty_blocks"], "chain": g["chain"],
           "chain_equals_native": g["chain_equals_witness"],
           "pools": g["pools"], "evidence": g["rejection_evidence"],
           "evidence_native": gw["rejection_evidence"], "stake": g["stake"],
           "stake_native": gw["stake"],
           "native_round_wall_s": gw["round_wall_s"],
           "device_crypto_seconds": g["device_crypto_seconds"]}
    emit("acceptance", **row)
    for key in ("rejection_evidence", "stake"):
        if g[key] != gw[key]:
            raise AssertionError(f"acceptance (a): the armed plane's {key} "
                                 f"{g[key]} is not the native plane's "
                                 f"{gw[key]}")
    return {**row, "b2_launches": g["b2_launches"],
            "b3_launches": g["b3_round_launches"]}


def acceptance_two_hives(dev) -> dict:
    """acceptance (b): two hives of 50 under drops and churn
    (test_hive.py:353), then one batch of the first hive's stepper."""
    import asyncio

    from biscotti_tpu_torch.runtime import hive as phive
    from biscotti_tpu_torch.runtime.faults import FaultPlan
    from biscotti_tpu_torch.runtime.membership import surviving_prefix_oracle

    t0, before = time.perf_counter(), kernel_launches()
    n, rounds = ACCEPT_HIVES_N, 3
    plan = FaultPlan(seed=23, drop=0.02, delay=0.10, delay_s=0.02,
                     churn=0.05, churn_period=2, churn_down=1)
    schedule = plan.churn_schedule(n, rounds)
    if not schedule:
        raise AssertionError("acceptance (b): the seed does not churn")
    cfg = drill_cfg(0, n, free_base(ACCEPT_BASE_PORT + 100, n), "two_hives",
                    max_iterations=rounds, fault_plan=plan)
    rss_before = phive.rss_bytes()
    hives = [phive.Hive(cfg, range(0, n // 2), hive_id="c1"),
             phive.Hive(cfg, range(n // 2, n), hive_id="c2")]

    async def go():
        return await asyncio.gather(*(h.run() for h in hives))

    t_start = time.time()
    runs = asyncio.run(go())
    run_s = time.time() - t_start
    results = [r for run in runs for r in run]
    equal, settled, real = surviving_prefix_oracle(results)
    summaries = [phive.summarize(h, run, run_s, rounds)
                 for h, run in zip(hives, runs)]
    batch = None
    if hives[0].stepper is not None:
        w = np.asarray(hives[0].agents[0].chain.latest_gradient())
        batch, _ = stepper_batch(dev, hives[0].stepper, w, rounds)
    row = drill_line(
        "b_two_hives", t0, t_start, log_stamps(results[0]), before,
        peers=n, results=len(results), prefix_equal=equal,
        settled=settled, real_blocks=real,
        churn_schedule=[[e.round, e.node, e.kind] for e in schedule],
        churned=sum(bool(r.get("churned")) for r in results),
        faults_injected=sum(sum(r.get("faults", {}).values())
                            for r in results),
        loopback_rpcs=sum(counter_total(a.pool.metrics,
                                        phive.LOOPBACK_RPCS_METRIC)
                          for h in hives for a in h.agents),
        devices=sorted({str(h.device) for h in hives}),
        batched=[h.stepper is not None for h in hives],
        rss_before_bytes=rss_before,
        rss_growth_per_peer_bytes=(max(h.info["rss_sampled_max_bytes"]
                                       for h in hives) - rss_before) // n,
        rss_sampled_max_bytes=[s["rss_sampled_max_bytes"] for s in summaries],
        loop_lag_s=[s["loop_lag_s"] for s in summaries],
        s_per_iter=[s["s_per_iter"] for s in summaries], batch=batch)
    emit("acceptance", **row)
    if not (len(results) == n and equal and settled >= 1
            and row["faults_injected"] > 0 and row["loopback_rpcs"] > 0
            and row["devices"] == ["cuda"]):
        raise AssertionError(f"acceptance (b): {len(results)} results, the "
                             f"surviving prefixes differ or settled nothing, "
                             f"no fault fired or no loopback RPC: {row}")
    return row


def acceptance_rebalance() -> dict:
    """acceptance (c): the rebalance of N = 100 under secure aggregation
    and verification (test_placement.py:377), through the port's
    PlacementController and the reference's rigged host signals."""
    import asyncio

    from biscotti_tpu_torch.runtime import placement as pl
    from biscotti_tpu_torch.runtime.hive import LoopbackHub
    from biscotti_tpu_torch.runtime.membership import surviving_prefix_oracle
    from biscotti_tpu_torch.runtime.peer import PeerAgent

    t0, before = time.perf_counter(), kernel_launches()
    n = ACCEPT_REBALANCE_N
    plan = pl.PlacementPlan(enabled=True, seed=0, interval=1, max_moves=2,
                            lag_hot_s=0.05)
    layout = pl.hive_layout(n, 2)
    if pl.aligned_overlay_group(layout) != n // 2:
        raise AssertionError(f"acceptance (c): layout {layout}")
    hive_ids = ["host0", "host1"]
    assignment = {node: hid for hid, (start, count) in zip(hive_ids, layout)
                  for node in range(start, start + count)}
    cfg = drill_cfg(0, n, free_base(ACCEPT_BASE_PORT + 300, n), "rebalance",
                    secure_agg=True, noising=True, verification=True,
                    sample_percent=0.2, placement_plan=plan)
    cfg = cfg.replace(timeouts=cfg.timeouts.scaled(
        n, cfg.num_verifiers, cfg.num_miners))
    hubs = {hid: LoopbackHub() for hid in hive_ids}
    made = {}

    def make_agent(node, hive_id, ticket):
        made[node] = PeerAgent(cfg.replace(node_id=node), hive=hubs[hive_id],
                               ticket=ticket)
        return made[node]

    def rigged(assignment, agents):
        # the reference's rig: process-wide gauges read equally hot on one
        # box, so the pressure comes through the signals_fn seam
        by = {}
        for node, hid in sorted(assignment.items()):
            by.setdefault(hid, []).append(node)
        return [pl.HostSignals(hive_id=hid, peers=tuple(nodes),
                               loop_lag_s=1.0 if hid == "host0" else 0.0)
                for hid, nodes in sorted(by.items())]

    ctl = pl.PlacementController(make_agent, assignment, plan,
                                 signals_fn=rigged)
    t_start = time.time()
    results = asyncio.run(asyncio.wait_for(ctl.run(), 900))
    equal, settled, real = surviving_prefix_oracle(results)
    moved = {node: next(r for r in results if r["node"] == node)
             for _, node, _, _ in ctl.moves_applied}
    stake = made[0].chain.latest_stake_map()
    # round times from a peer that never moved (a moved one logs only
    # its last incarnation's rounds)
    row = drill_line(
        "c_rebalance", t0, t_start,
        log_stamps(next(r for r in results if r["node"] not in moved)),
        before,
        peers=n, prefix_equal=equal, settled=settled, real_blocks=real,
        moves=[list(m) for m in ctl.moves_applied],
        moved_state={node: [r["migrations"],
                            r["counters"].get("migration_restored", 0)]
                     for node, r in moved.items()},
        downtimes_s=ctl.downtimes_s, ticket_bytes=ctl.ticket_bytes,
        chain=made[0].chain.dump().splitlines()[1:],
        counters=summed_counters(results),
        phases_total_s=summed_phases(results),
        round0_events=round_events(made.values(), 0, t_start),
        stakes=len(stake), min_stake=min(stake.values()),
        default_stake=cfg.default_stake,
        devices=trainer_devices(made.values()))
    emit("acceptance", **row)
    if not (equal and real >= 1 and len(ctl.moves_applied) >= 2
            and all(src == "host0" and dst == "host1"
                    for _, _, src, dst in ctl.moves_applied)
            and all(m >= 1 and restored >= 1
                    for m, restored in row["moved_state"].values())
            and len(stake) == n
            and all(v >= cfg.default_stake for v in stake.values())
            and row["devices"] == ["cuda:0"]):
        raise AssertionError(f"acceptance (c): the rebalance forked, moved "
                             f"fewer than 2 peers host0 -> host1, lost a "
                             f"moved peer's state or debited an honest "
                             f"stake: {row}")
    return row


def acceptance_slow_fleet() -> dict:
    """acceptance (d): 10 mnist peers, the tee preset on 2 of them
    (test_stragglers.py:522)."""
    from biscotti_tpu_torch.runtime.faults import FaultPlan
    from biscotti_tpu_torch.tools import chaos, obs

    t0, before = time.perf_counter(), kernel_launches()
    n = ACCEPT_FLEET_N
    # the reference's scan: the seed whose tee preset slows exactly 2 of 10
    seed = next(s for s in range(500)
                if len(FaultPlan(seed=s, slow=0.2,
                                 slow_preset="tee").slow_table(n)) == 2)
    plan = FaultPlan(seed=seed, slow=0.2, slow_preset="tee")
    slow_ids = sorted(plan.slow_table(n))
    port = free_base(ACCEPT_BASE_PORT + 500, n)

    agents, results, t_start, _ = drill_cluster([drill_cfg(
        i, n, port, "slow_fleet", fault_plan=plan, secure_agg=True,
        verification=True, batch_size=10, adaptive_deadlines=True,
        deadline_floor_s=1.0, max_iterations=5) for i in range(n)])
    equal, common, real = chaos.chain_oracle(results)
    stake = agents[0].chain.latest_stake_map()
    merged = obs.merge_snapshots([r["telemetry"] for r in results])
    table = obs.format_table(merged)
    row = drill_line(
        "d_slow_fleet", t0, t_start, log_stamps(results[0]), before,
        peers=n, fault_seed=seed, slow_ids=slow_ids, prefix_equal=equal,
        common=common, real_blocks=real,
        opens_toward_slow={sid: sum(r["telemetry"]["health"]
                                    .get(str(sid), {}).get("opens", 0)
                                    for r in results if r["node"] != sid)
                           for sid in slow_ids},
        slow_stake={sid: stake.get(sid, 0) for sid in slow_ids},
        default_stake=agents[0].cfg.default_stake,
        slow_peers=len(merged["stragglers"]["slow_peers"]),
        adaptive_peers=merged["stragglers"]["adaptive_peers"],
        table_rows=[ln for ln in table.splitlines()
                    if "stragglers:" in ln or "waiting-on" in ln],
        devices=trainer_devices(agents))
    emit("acceptance", **row)
    if not (equal and common >= 3 and real >= 2
            and not any(row["opens_toward_slow"].values())
            and all(v >= row["default_stake"]
                    for v in row["slow_stake"].values())
            and row["slow_peers"] == 2 and row["adaptive_peers"] == n
            and "stragglers:" in table and "waiting-on" in table
            and row["devices"] == ["cuda:0"]):
        raise AssertionError(f"acceptance (d): the slow fleet parted, made "
                             f"fewer than 2 real blocks in a common prefix "
                             f"of 3, quarantined or debited a tee peer, or "
                             f"its obs merge lacks the stragglers: {row}")
    return row


def acceptance_churn_verdict() -> dict:
    """acceptance (e): 20 % turnover on 8 peers for 12 rounds with 30 %
    poisoners under FOOLSGOLD (test_membership.py:658): a snapshot-
    bootstrapped ChurnRunner run, then the plain run, whose settled
    defense verdicts must agree."""
    import asyncio

    from biscotti_tpu_torch.config import Defense
    from biscotti_tpu_torch.runtime.faults import FaultPlan
    from biscotti_tpu_torch.runtime.membership import (ChurnRunner,
                                                       surviving_prefix_oracle)
    from biscotti_tpu_torch.runtime.peer import PeerAgent
    from biscotti_tpu_torch.tools.verdicts import (chain_defense_verdict,
                                                   poisoned_ids)

    t0, before = time.perf_counter(), kernel_launches()
    n, rounds = ACCEPT_CHURN_N, ACCEPT_CHURN_ROUNDS
    plan = FaultPlan(seed=15, churn=0.2, churn_period=6, churn_down=2)
    schedule = plan.churn_schedule(n, rounds)
    poisoned = poisoned_ids(n, 0.3)
    if not (schedule and poisoned):
        raise AssertionError("acceptance (e): no churn or no poisoner")

    def make_cfg(i, port, snap):
        return drill_cfg(i, n, port, "churn_verdict", num_miners=2,
                         secure_agg=True, verification=True,
                         max_iterations=rounds, rpc_retries=1,
                         poison_fraction=0.3, defense=Defense.FOOLSGOLD,
                         snapshot_bootstrap=snap, snapshot_tail=4)

    def accepted_poisoned(anchor):
        return sorted(chain_defense_verdict(anchor.chain.blocks,
                                            poisoned)["accepted_poisoned"])

    churn_port = free_base(ACCEPT_BASE_PORT + 600, n)
    plain_port = free_base(ACCEPT_BASE_PORT + 650, n)

    async def churn_run():
        made = {}

        def make(i):
            made[i] = PeerAgent(make_cfg(i, churn_port, snap=True))
            return made[i]

        runner = ChurnRunner(make, n, schedule)
        return await runner.run(), made[0], runner.events_applied

    async def plain_run():
        agents = [PeerAgent(make_cfg(i, plain_port, snap=False))
                  for i in range(n)]
        return await asyncio.gather(*(a.run() for a in agents)), agents[0]

    t_start = time.time()
    churn_results, churn_anchor, applied = asyncio.run(churn_run())
    churn_s = time.time() - t_start
    equal, settled, real = surviving_prefix_oracle(churn_results)
    t_plain = time.time()
    plain_results, plain_anchor = asyncio.run(plain_run())
    pequal, psettled, preal = surviving_prefix_oracle(plain_results)
    replayed = FaultPlan(seed=15, churn=0.2, churn_period=6,
                         churn_down=2).churn_schedule(n, rounds) == schedule
    row = drill_line(
        "e_churn_verdict", t0, t_start,
        log_stamps(next(r for r in churn_results if r["node"] == 0)), before,
        peers=n, churn_s=churn_s,
        plain_round_wall_s=round_walls(t_plain, log_stamps(plain_results[0])),
        schedule=[[e.round, e.node, e.kind] for e in schedule],
        events_applied=[list(e) for e in applied], schedule_replays=replayed,
        prefix_equal=equal, settled=settled, real_blocks=real,
        plain_prefix_equal=pequal, plain_settled=psettled, plain_real=preal,
        poisoned=sorted(poisoned),
        accepted_poisoned=accepted_poisoned(churn_anchor),
        accepted_poisoned_plain=accepted_poisoned(plain_anchor),
        devices=trainer_devices((churn_anchor, plain_anchor)))
    emit("acceptance", **row)
    if not (equal and settled >= rounds // 2 and real >= 1 and replayed
            and pequal and preal >= 1
            and row["accepted_poisoned"] == row["accepted_poisoned_plain"]
            and row["devices"] == ["cuda:0"]):
        raise AssertionError(f"acceptance (e): the churn run parted, settled "
                             f"too little or made no real block, the schedule "
                             f"does not replay, the plain run failed, or the "
                             f"defense verdict moved under churn: {row}")
    return row


def acceptance_upgrade(prewarm_b3: dict) -> dict:
    """acceptance (f): the rolling upgrade at N = 8 under secure
    aggregation and f32+zlib (test_upgrade.py:116) through the chaos CLI."""
    from biscotti_tpu_torch.runtime import protocol

    # chaos_cell's crypto_switch sets B2's and B3's counters to 0 as the
    # cell starts, B1's it leaves
    t0 = time.perf_counter()
    before = {k: v if k == "B1" else 0 for k, v in kernel_launches().items()}
    t_start = time.time()
    cli, report, agents = chaos_cell("f_rolling_upgrade", 8,
                                     ACCEPT_UPGRADE_FLAGS, prewarm_b3)
    ru = report["rolling_upgrade"]
    anchor = [a for a in agents if a.id == 0][-1]
    row = drill_line(
        "f_rolling_upgrade", t0, t_start, [t for _, _, t in anchor.logs],
        before, argv=cli["argv"], rc=cli["rc"], waves=ru["waves"],
        applied=ru["applied"], final_versions=ru["final_versions"],
        current_version=protocol.CURRENT_VERSION,
        prefix_equal=report["settled_prefix_equal"],
        settled=report["settled_height"], real_blocks=report["real_blocks"],
        feature_degraded=report["cluster"]["counters"].get(
            "feature_degraded", 0),
        devices=cli["devices"])
    emit("acceptance", **row)
    if not (cli["rc"] == 0 and [w[0] for w in ru["waves"]] == [2, 4, 6]
            and len(ru["applied"]) == 7
            and set(ru["final_versions"].values())
            == {protocol.CURRENT_VERSION}
            and report["settled_prefix_equal"]
            and report["real_blocks"] >= 1):
        raise AssertionError(f"acceptance (f): the rolling upgrade failed "
                             f"(rc, waves, the 7 upgrades, the final "
                             f"versions or the settled prefix): {row}")
    return row


def acceptance_phase(dev, prewarm_b3: dict,
                     cells: str = ACCEPT_CELLS) -> dict:
    """The reference's slow acceptance drills on the card, the `cells` of
    (a)-(f) of the module docstring (ACCEPT_CELLS: all but (c), which
    ROADMAP C16 keeps from its gate on the card); returns the phase's
    row with (a)'s B2 and B3 launches (B3's beyond the peers' prewarms)
    and every cell's B1 launches."""
    import torch

    from biscotti_tpu_torch.config import BiscottiConfig

    drills = {"a": lambda: acceptance_guard(prewarm_b3),
              "b": lambda: acceptance_two_hives(dev),
              "c": acceptance_rebalance, "d": acceptance_slow_fleet,
              "e": acceptance_churn_verdict,
              "f": lambda: acceptance_upgrade(prewarm_b3)}
    t_phase = time.perf_counter()
    warm_cell(BiscottiConfig(dataset="mnist", batch_size=8))
    rows = {k: drills[k]() for k in cells}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_phase
    emit("acceptance", cell="phase", seconds=seconds,
         cells_s={k: r["seconds"] for k, r in rows.items()})
    zero = {wrapper: 0 for _, wrapper, _ in LADDER.values()}
    guard = rows.get("a", {"b2_launches": 0, "b3_launches": zero})
    return {"b1_launches": sum(r["launches"]["B1"] for r in rows.values()),
            "b2_launches": guard["b2_launches"],
            "b3_launches": guard["b3_launches"], "seconds": seconds}


def matrix_chaos() -> dict:
    """matrices (a): the chaos matrix (test_faults.py:521), each of its
    five FaultPlans (seed 29) on 4 peers for 4 rounds: the settled prefix
    equal over a common height of 2 or more with a real block, and a
    fault injected, in every case."""
    from biscotti_tpu_torch.runtime.faults import FaultPlan
    from biscotti_tpu_torch.tools import chaos

    t0, before = time.perf_counter(), kernel_launches()
    n, cases = 4, {}
    for case, kw in MATRIX_CHAOS_CASES.items():
        plan = FaultPlan(seed=MATRIX_CHAOS_SEED, **kw)
        port = free_base(MATRIX_BASE_PORT, n)
        t_case = time.perf_counter()
        agents, results, t_start, _ = drill_cluster(
            [drill_cfg(i, n, port, "chaos_matrix", fault_plan=plan,
                       max_iterations=4) for i in range(n)])
        equal, common, real = chaos.chain_oracle(results)
        counters = summed_counters(results)
        cases[case] = {
            "plan": kw, "wall_s": time.perf_counter() - t_case,
            "round_wall_s": round_walls(t_start, log_stamps(results[0])),
            "prefix_equal": equal, "common": common, "real_blocks": real,
            "faults": chaos.tally_faults(results),
            "rpc_retries": counters.get("rpc_retry", 0),
            "breaker_opens": counters.get("breaker_open", 0),
            "devices": trainer_devices(agents)}
    row = drill_line("a_chaos_matrix", t0, time.time(), [], before,
                     peers=n, fault_seed=MATRIX_CHAOS_SEED, cases=cases)
    emit("matrices", **row)
    bad = [k for k, c in cases.items()
           if not (c["prefix_equal"] and c["common"] >= 2
                   and c["real_blocks"] >= 1 and c["faults"]
                   and c["devices"] == ["cuda:0"])]
    if bad:
        raise AssertionError(f"matrices (a): the settled prefix parted, "
                             f"reached no height 2, held no real block, no "
                             f"fault was injected or a peer left the card in "
                             f"{bad}: {row}")
    return row


def matrix_flood() -> dict:
    """matrices (b): the mnist flood acceptance (test_admission.py:597): 4
    peers with node 1 flooding 50x under the TIGHT admission plan, then
    the same cluster with admission and no flood, then with neither."""
    from biscotti_tpu_torch.runtime.admission import AdmissionPlan
    from biscotti_tpu_torch.runtime.faults import FaultPlan
    from biscotti_tpu_torch.tools import chaos

    t0, before = time.perf_counter(), kernel_launches()
    n, flooder = 4, MATRIX_FLOOD_NODE
    tight = AdmissionPlan(enabled=True, update_rate=8.0, bulk_rate=6.0,
                          control_rate=16.0)

    def run(name: str, flood: int, admission) -> dict:
        port = free_base(MATRIX_BASE_PORT + 100, n)
        plan = FaultPlan(seed=13)
        flood_plan = FaultPlan(seed=13, flood=flood)
        t_run = time.perf_counter()
        agents, results, t_start, _ = drill_cluster([drill_cfg(
            i, n, port, "flood", admission_plan=admission, max_iterations=3,
            fault_plan=flood_plan if flood and i == flooder else plan)
            for i in range(n)])
        equal, common, real = chaos.chain_oracle(results)
        snaps = [r["telemetry"] for r in results]
        return {
            "run": name, "wall_s": time.perf_counter() - t_run,
            "round_wall_s": round_walls(t_start, log_stamps(results[0])),
            "prefix_equal": equal, "common": common, "real_blocks": real,
            "faults": chaos.tally_faults(results),
            "sheds": [s["admission"]["shed_total"] for s in snaps],
            "honest_sheds": sum(s["admission"]["shed_total"] for s in snaps
                                if s["node"] != flooder),
            "peaks": [[s["node"], s["admission"]["inflight_peak"],
                       s["admission"]["caps"]["global_inflight"],
                       s["admission"]["parked_peak"],
                       s["admission"]["caps"]["max_parked"]]
                      for s in snaps],
            # every breaker open between honest peers
            "honest_opens": [[s["node"], pid, h.get("opens", 0)]
                             for s in snaps if s["node"] != flooder
                             for pid, h in s["health"].items()
                             if int(pid) != flooder and h.get("opens", 0)],
            "breaker_open": [r["telemetry"]["counters"].get("breaker_open", 0)
                             for r in results],
            "final_error": results[0]["final_error"],
            "devices": trainer_devices(agents)}

    runs = [run("flood", MATRIX_FLOOD_X, tight), run("clean", 0, tight),
            run("baseline", 0, AdmissionPlan())]
    flood, clean, base = runs
    gap = abs(clean["final_error"] - base["final_error"])
    row = drill_line("b_matrix_flood", t0, time.time(), [], before,
                     peers=n, flooder=flooder, flood_x=MATRIX_FLOOD_X,
                     runs=runs, error_gap=gap)
    emit("matrices", **row)
    if not (flood["prefix_equal"] and flood["common"] >= 2
            and flood["real_blocks"] >= 1 and flood["honest_sheds"] > 0
            and all(inf <= inf_cap and park <= park_cap
                    for _, inf, inf_cap, park, park_cap in flood["peaks"])
            and not flood["honest_opens"]):
        raise AssertionError(f"matrices (b): the flood run parted, held no "
                             f"real block in a common prefix of 2, shed "
                             f"nothing on an honest peer, passed a cap or "
                             f"opened a breaker between honest peers: "
                             f"{flood}")
    if not (clean["prefix_equal"] and clean["real_blocks"] >= 1
            and not any(clean["sheds"]) and not any(clean["breaker_open"])
            and base["prefix_equal"] and base["real_blocks"] >= 1
            and gap < MATRIX_ERROR_GAP):
        raise AssertionError(f"matrices (b): the clean run shed or opened a "
                             f"breaker, a run without the flood parted or "
                             f"held no real block, or the final errors lie "
                             f"{gap} apart: {clean} {base}")
    if any(r["devices"] != ["cuda:0"] for r in runs):
        raise AssertionError(f"matrices (b): a peer left the card: {row}")
    return row


def matrix_attack() -> dict:
    """matrices (c): the attack-matrix driver (test_adversary.py:636),
    `eval.eval_attack_matrix.main` over {static, hug} x {NONE, KRUM} on 5
    mnist peers for 3 rounds, its artifacts in a temporary directory."""
    import io
    import tempfile

    from biscotti_tpu_torch.eval import eval_attack_matrix as am

    t0, before = time.perf_counter(), kernel_launches()
    cells = 4
    # each cell takes the next block of nodes + 2 ports
    port = free_base(MATRIX_BASE_PORT + 200, cells * 7)
    with tempfile.TemporaryDirectory() as tmp:
        argv = MATRIX_ATTACK_ARGV + ["--base-port", str(port), "--out", tmp]
        with PeerRecorder(am) as rec, \
                contextlib.redirect_stdout(io.StringIO()):
            rc = am.main(argv)
        art = json.loads(open(os.path.join(tmp, "am_smoke.json")).read())
        csv = os.path.exists(os.path.join(tmp, "am_smoke.csv"))
    rows = art["rows"]
    columns = {"campaign", "defense", "secure_agg", "final_error",
               "chains_equal", "survived", "failed", "verdict", "replay"}
    row = drill_line(
        "c_matrix_attack", t0, time.time(), [], before, argv=argv, rc=rc,
        csv_written=csv, agents=len(rec.agents),
        devices=trainer_devices(rec.agents),
        rows=[{k: r.get(k) for k in (
            "campaign", "defense", "secure_agg", "final_error",
            "chains_equal", "settled", "real_blocks", "survived", "failed",
            "accepted_poisoned_n", "replay", "error")} for r in rows])
    emit("matrices", **row)
    if not (rc == 0 and len(rows) == cells and csv and all(
            columns <= set(r) and r["failed"] == (0 if r["survived"] else 1)
            and "tools.chaos" in r["replay"]
            and (r["campaign"] == "none" or not r["survived"]
                 or r["verdict"]["n_accepted_poisoned"] == 0)
            for r in rows)):
        raise AssertionError(f"matrices (c): the attack matrix failed (rc, "
                             f"4 rows with the columns, the failed bit, the "
                             f"replay, a survivor with a poisoned record "
                             f"accepted, or no csv): {row}")
    if row["devices"] != ["cuda:0"]:
        raise AssertionError(f"matrices (c): a peer left the card: {row}")
    return row


def matrix_trace_overlay(prewarm_b3: dict) -> dict:
    """matrices (d): the traced overlay under chaos (test_tracing.py:532):
    8 secure-aggregation peers with verification, 2 miners, the overlay in
    groups of 4 and a FaultPlan, 3 rounds, armed on the card, polled mid-
    run by `tools.trace_round.poll_cluster`."""
    from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv
    from biscotti_tpu_torch.runtime.faults import FaultPlan
    from biscotti_tpu_torch.tools import chaos
    from biscotti_tpu_torch.tools import trace_round as tr

    # crypto_switch sets B2's and B3's counters to 0 as the cell starts
    t0 = time.perf_counter()
    before = {k: v if k == "B1" else 0 for k, v in kernel_launches().items()}
    n = MATRIX_TRACE_PEERS
    port = free_base(MATRIX_BASE_PORT + 300, n)
    plan = FaultPlan(**MATRIX_TRACE_PLAN)
    cfgs = [drill_cfg(i, n, port, "trace_overlay", num_miners=2,
                      secure_agg=True, verification=True, trace=True,
                      overlay=True, overlay_group=4, max_iterations=3,
                      fault_plan=plan, device_crypto=True)
            for i in range(n)]

    async def poll(agents):
        return await tr.poll_cluster("127.0.0.1", [port + i for i in range(n)],
                                     **MATRIX_TRACE_POLL)

    with crypto_switch(arm=True):
        agents, results, t_start, events = drill_cluster(cfgs, poll)
        b3 = cl.launches()
    # every armed peer prewarms once before its first round
    b3_rounds = {k: v - n * prewarm_b3[k] for k, v in b3.items()}
    recon = tr.reconstruct(events, min_nodes=MATRIX_TRACE_POLL["min_nodes"])
    complete = [r for r in recon["rounds"] if r["complete"]]
    best = max(complete, key=lambda r: r["critical"]["coverage"],
               default=None)
    obj = tr.chrome_trace(recon["traces"])
    tr.validate_chrome(obj)  # raises on a malformed trace
    overlay = {k: sum(r["telemetry"]["overlay"][k] for r in results)
               for k in ("aggregated", "relayed", "direct", "fallback")}
    cp = best["critical"] if best else None
    row = drill_line(
        "d_matrix_trace_overlay", t0, t_start, log_stamps(results[0]), before,
        peers=n, polled_events=len(events),
        rounds_reconstructed=len(recon["rounds"]), complete_rounds=len(complete),
        best=best and {"round": best["round"], "nodes": best["nodes"],
                       "critical_nodes": cp["nodes"],
                       "coverage": cp["coverage"], "wall_s": cp["wall_s"],
                       "segments": cp["segments"]},
        chrome_x_events=sum(e["ph"] == "X" for e in obj["traceEvents"]),
        chains_equal=all(r["chain_dump"] == results[0]["chain_dump"]
                         for r in results),
        real_blocks=sum("ndeltas=0" not in ln for ln in
                        results[0]["chain_dump"].splitlines()[1:]),
        overlay=overlay, faults=chaos.tally_faults(results),
        rpc_retries=summed_counters(results).get("rpc_retry", 0),
        b3_launches_with_prewarms=b3, devices=trainer_devices(agents))
    # B2's launches are its count under the switch; B3's beyond the
    # prewarms
    row["launches"].update({kid: b3_rounds[wrapper]
                            for kid, (_, wrapper, _) in LADDER.items()})
    row["launches"]["B2"] = cv.oncurve_mask.launches
    emit("matrices", **row)
    if not row["chains_equal"]:
        raise AssertionError(f"matrices (d): the chains differ: {row}")
    if not (cp and len(cp["nodes"]) >= 2 and len(best["nodes"]) >= 3
            and cp["coverage"] >= 0.8
            and abs(sum(cp["segments"].values()) - cp["wall_s"]) < 1e-3
            and row["chrome_x_events"]):
        raise AssertionError(f"matrices (d): no complete round spans 3 "
                             f"peers with a critical path over 2 covering "
                             f"80 % of its wall time and summing to it, or "
                             f"the chrome trace has no X event: {row}")
    if min(b3_rounds[k] for k in ("msm_ladder", "fixed_walk",
                                  "point_add")) < 1:
        raise AssertionError(f"matrices (d)'s rounds did not launch B3a, B3b "
                             f"and B3d beyond the prewarms: {b3_rounds}")
    if row["devices"] != ["cuda:0"]:
        raise AssertionError(f"matrices (d): a peer left the card: {row}")
    return row


def matrix_soak() -> dict:
    """matrices (e): one full cycle of `tools.soak.main` on the card: 6
    mnist peers for 8 rounds under the CLI's churn, roleflood campaign,
    stragglers, drops and SLO limits, one migration and a rolling upgrade
    from protocol row 0."""
    import io
    import tempfile

    from biscotti_tpu_torch.tools import soak

    t0, before = time.perf_counter(), kernel_launches()
    nodes = int(MATRIX_SOAK_ARGV[MATRIX_SOAK_ARGV.index("--nodes") + 1])
    port = free_base(MATRIX_BASE_PORT + 400, nodes)  # cycle 0's block
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "soak.json")
        argv = MATRIX_SOAK_ARGV + ["--base-port", str(port), "--out", path]
        with PeerRecorder() as rec, contextlib.redirect_stdout(io.StringIO()):
            rc = soak.main(argv)
        art = json.loads(open(path).read())
    cycle = art["cycles"][0]
    row = drill_line(
        "e_matrix_soak", t0, time.time(), [], before, argv=argv, rc=rc,
        schema=art["schema"], cycles_run=art["cycles_run"],
        elapsed_s=art["elapsed_s"], prefix_held=art["prefix_held"],
        settled_rounds=art["settled_rounds"],
        real_blocks=cycle["real_blocks"], gates=art["gates"],
        p50_round_latency_s=art["p50_round_latency_s"],
        migrations=len(cycle["migrations"]),
        migrations_restored=cycle["migrations_restored"],
        upgrades_applied=cycle["upgrades_applied"],
        churn_events_applied=cycle["churn_events_applied"],
        sheds=cycle["sheds"], stalls=cycle["stalls"], faults=cycle["faults"],
        rss_series_bytes=art["rss_series_bytes"],
        agents=len(rec.agents), devices=trainer_devices(rec.agents))
    emit("matrices", **row)
    # ROADMAP C19: one cycle's RSS rise (new incarnations, the chains) over
    # its ~20 s, scaled to an hour, passes the drift gate's 512 MiB/h only
    # if RSS stays within ~1 MB; the reference's soak fails it the same
    # way on this cycle, so the cell holds every other gate and reports it
    held = [k for k, g in art["gates"].items()
            if k != SOAK_DRIFT_GATE and not g["pass"]]
    if not (art["prefix_held"] and not held
            and art["cycles_run"] == 1 and art["schema"] == "soak-v1"
            and cycle["real_blocks"] >= 1):
        raise AssertionError(f"matrices (e): the soak failed (the surviving-"
                             f"prefix oracle with a real block, an SLO gate "
                             f"other than the RSS drift, one cycle, the "
                             f"schema): {row}")
    if row["devices"] != ["cuda:0"]:
        raise AssertionError(f"matrices (e): a peer left the card: {row}")
    return row


def matrices_phase(dev, prewarm_b3: dict, cells: str = MATRIX_CELLS) -> dict:
    """The reference's last slow drills and the port's soak on the card,
    the `cells` of (a)-(e) of the module docstring; returns the phase's
    row with every kernel's launches over its cells (B3's beyond the
    peers' prewarms)."""
    import torch

    from biscotti_tpu_torch.config import BiscottiConfig

    drills = {"a": matrix_chaos, "b": matrix_flood, "c": matrix_attack,
              "d": lambda: matrix_trace_overlay(prewarm_b3), "e": matrix_soak}
    t_phase = time.perf_counter()
    warm_cell(BiscottiConfig(dataset="mnist", batch_size=8))
    rows = {k: drills[k]() for k in cells}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_phase
    launches = {kid: sum(r["launches"][kid] for r in rows.values())
                for kid in kernel_launches()}
    emit("matrices", cell="phase", seconds=seconds,
         cells_s={k: r["seconds"] for k, r in rows.items()}, launches=launches,
         b1_note="B1 0: every verifier pool here is under 512")
    return {"b1_launches": launches["B1"], "b2_launches": launches["B2"],
            "b3_launches": {wrapper: launches[kid]
                            for kid, (_, wrapper, _) in LADDER.items()},
            "seconds": seconds}


def hive_cell(name: str, cfg, pool_hook: bool = False):
    """A port `Hive` of every peer of `cfg` on the card (device None: the
    GPU), run to the end: (row, hive, results, the verifier pools of 512 or
    more rows that `_defense_mask` was handed). The row holds the chain-
    equality oracle, each round's wall time (peer 0's log stamps, the
    first from the run's start), the verifier decisions [round, pool,
    accepted], the stepper's batches and the hive's readout."""
    import asyncio

    from biscotti_tpu_torch.runtime import hive as phive

    rss_before = phive.rss_bytes()
    t_setup = time.perf_counter()
    hive = phive.Hive(cfg, hive_id=name)
    setup_s = time.perf_counter() - t_setup
    pools = []
    if pool_hook:
        for agent in hive.agents:
            def seen(vecs, _mask=agent._defense_mask):
                if len(vecs) >= 512:
                    pools.append(np.array(vecs, np.float32))
                return _mask(vecs)

            agent._defense_mask = seen
    t0 = time.time()
    results = asyncio.run(hive.run())
    run_s = time.time() - t0
    summary = phive.summarize(hive, results, run_s, cfg.max_iterations)
    blocks = results[0]["chain_dump"].splitlines()[1:]
    stamps = log_stamps(results[0])
    stream = sorted((int(v["it"]), [int(x) for x in v["src"]],
                     [bool(x) for x in v["accept"]])
                    for r in results
                    for v in r["telemetry"].get("trust", {}).get("stream", []))
    verdicts = [[it, len(src), sum(acc)] for it, src, acc in stream]
    row = {"cell": name, "peers": cfg.num_nodes, "base_port": cfg.base_port,
           "dataset": cfg.dataset,
           "model": cfg.model_name or "default",
           "params": hive.agents[0].trainer.num_params,
           "device": str(hive.device),
           "chains_equal": summary["chains_equal_local"],
           "rounds": len(blocks), "rounds_wanted": cfg.max_iterations,
           "nonempty_blocks": sum("ndeltas=0" not in b for b in blocks),
           "verdicts": verdicts, "setup_s": setup_s, "run_s": run_s,
           "round_wall_s": [b - a for a, b in zip([t0] + stamps, stamps)],
           "sgd_batches": summary["sgd_batches"],
           "evals": hive.stepper.evals if hive.stepper else None,
           # the process's RSS before the hive and at the monitor's last
           # sample of its run: this process has run every earlier phase,
           # so its peak is theirs too, and the growth is the hive's
           "rss_before_bytes": rss_before,
           "rss_in_run_bytes": hive.info["rss_bytes"],
           "rss_growth_per_peer_bytes":
               (hive.info["rss_bytes"] - rss_before) // cfg.num_nodes,
           "rss_sampled_max_bytes": summary["rss_sampled_max_bytes"],
           "loop_lag_s": summary["loop_lag_s"],
           "loopback_avoided_bytes_per_round":
               summary["loopback_avoided_bytes_per_round"],
           "final_error": summary["final_error"],
           "phases_total_s": summed_phases(results),
           "anchor_phases_s": {k: round(v["total_s"], 4) for k, v in sorted(
               results[0]["phases"].items(), key=lambda kv: -kv[1]["total_s"])},
           "chain": blocks}
    if not (row["chains_equal"] and row["rounds"] == row["rounds_wanted"]
            and row["nonempty_blocks"] == row["rounds"]
            and row["device"] == "cuda" and summary["batch_device"]):
        raise AssertionError(f"hive cell {name} failed the oracle: {row}")
    return row, hive, results, pools


def stepper_batch(dev, st, w: np.ndarray, it: int) -> tuple:
    """One HiveStepper batch of round `it` at weights `w`, after its run:
    ({its draws' host ms (3 draws), its time (CUDA events) and
    torch.profiler's device ms, kernel count and top kernels}, the
    batch's [H, d] deltas)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    wt = torch.from_numpy(w.astype(np.float32)).to(dev)
    draws_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = st.draw_batches(it)
        torch.cuda.synchronize()
        draws_ms.append(1e3 * (time.perf_counter() - t0))
    batch_ms = time_ms(lambda: st.deltas_from_draws(wt, idx), reps=5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        deltas = st.deltas_from_draws(wt, idx)
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"batch_peers": len(st.local_ids), "batch_ms": batch_ms,
            "batch_device_ms": sum(e.self_device_time_total
                                   for e in on_device) / 1e3,
            "batch_kernels": sum(e.count for e in on_device),
            "draws_host_ms": draws_ms,
            "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in sorted(
                         on_device, key=lambda e: -e.self_device_time_total)[:6]]
            }, deltas


def hive_phase(dev) -> dict:
    """The hive on the card, cells (a)-(d) of the module docstring; returns
    the phase's row with B1's launches in (c)'s live round."""
    import asyncio

    import torch

    from biscotti_tpu_torch import bench
    from biscotti_tpu_torch.config import BiscottiConfig, Defense
    from biscotti_tpu_torch.data import datasets as ds
    from biscotti_tpu_torch.models.trainer import Trainer
    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.ops.krum import default_num_adversaries
    from biscotti_tpu_torch.runtime.device_cluster import run_cluster

    t_phase = time.perf_counter()
    # (a) the reference's density entry, through the port's hive CLI
    t0 = time.perf_counter()
    density = bench.bench_peer_density(sizes=(HIVE_DENSITY_N,), iterations=2,
                                       budget_s=300.0, platform="cuda")
    a = density[f"n{HIVE_DENSITY_N}"]
    emit("hive", cell="a_density_n100", seconds=time.perf_counter() - t0, **a)
    if "error" in a or not (a["chains_equal"] and a["blocks"] == 2):
        raise AssertionError(f"hive (a): the density entry failed: {a}")

    def cell_cfg(n: int, port: int, rounds: int, **kw):
        cfg = BiscottiConfig(num_nodes=n, dataset="mnist",
                             base_port=free_base(port, n),
                             num_verifiers=1, num_miners=1, num_noisers=1,
                             secure_agg=False, noising=False,
                             verification=True, defense=Defense.KRUM,
                             max_iterations=rounds, convergence_error=0.0,
                             sample_percent=1.0, seed=0, **kw)
        # the hive CLI's deadlines (hive.py main): the reference's scaling
        return cfg.replace(timeouts=cfg.timeouts.scaled(
            n, 1, 1, random_sampling=False, defense_is_krum=True))

    # (b) 100 mnist_cnn peers; one batch profiled and held to the peers'
    # standalone Trainers on the card
    cfg_b = cell_cfg(HIVE_CNN_N, HIVE_BASE_PORT, HIVE_CNN_ROUNDS,
                     model_name="mnist_cnn")
    b, hive_b, _, _ = hive_cell("b_cnn_n100", cfg_b)
    st = hive_b.stepper
    w = np.asarray(hive_b.agents[0].chain.latest_gradient())
    it = cfg_b.max_iterations
    batch, deltas = stepper_batch(dev, st, w, it)
    worst = 0.0
    for slot, pid in enumerate(st.local_ids):
        t = Trainer(cfg_b.dataset, ds.shard_name(cfg_b.dataset, pid, False),
                    cfg=cfg_b.replace(node_id=pid), seed=pid)
        want = torch.from_numpy(t.private_fun(w, it))
        got = deltas[slot].double().cpu()
        diff = float((got - want).abs().max())
        worst = max(worst, diff)
        if not torch.allclose(got, want, rtol=RTOL,
                              atol=RTOL * float(want.abs().max())):
            raise AssertionError(f"hive (b): peer {pid}'s batched delta is "
                                 f"not its standalone Trainer's: {diff}")
    b.update(trainer_max_abs_diff=worst, **batch)
    emit("hive", **b)
    if b["sgd_batches"] != cfg_b.max_iterations:
        raise AssertionError(f"hive (b): {b['sgd_batches']} batches, not one "
                             f"a round")
    del hive_b, st, deltas
    torch.cuda.empty_cache()

    # (c) N = 528: the verifier's live pool in B1's window
    cfg_c = cell_cfg(HIVE_POOL_N, HIVE_BASE_PORT + 1000, HIVE_POOL_ROUNDS)
    krum_cuda.krum_scores_kernel.launches = 0
    c, _, _, pools = hive_cell("c_pool_n528", cfg_c, pool_hook=True)
    c["b1_launches"] = krum_cuda.krum_scores_kernel.launches
    c["pool_sizes"] = [len(p) for p in pools]
    # the round's verifier scores its pool of N - 2 on B1, once a pool
    if not (len(pools) >= HIVE_POOL_ROUNDS
            and all(len(p) >= 512 for p in pools)
            and c["b1_launches"] == len(pools)):
        raise AssertionError(f"hive (c): B1 scored no live pool of 512 or "
                             f"more: {c}")
    x = torch.from_numpy(pools[0]).to(dev)
    f = default_num_adversaries(x.shape[0])
    got, ref = krum_cuda.krum_scores_kernel(x, f), krum_cuda.krum_scores_plain(x, f)
    keep = x.shape[0] - f
    c["b1_on_the_live_pool"] = {
        "n": x.shape[0], "d": x.shape[1], "max_abs_err": float((got - ref).abs().max()),
        "max_rel_err": rel_err(got, ref),
        "accept_set_identical": accept_set(got, keep) == accept_set(ref, keep),
        **krum_times(x, f)}
    emit("hive", **{k: v for k, v in c.items() if k != "chain"},
         chain=c["chain"])
    if not (c["b1_on_the_live_pool"]["accept_set_identical"]
            and c["b1_on_the_live_pool"]["max_rel_err"] < RTOL):
        raise AssertionError(f"hive (c): B1 on the live pool disagrees with "
                             f"plain: {c['b1_on_the_live_pool']}")

    # (d) the single-device BatchStepper cluster
    cfg_d = cell_cfg(HIVE_CLUSTER_N, HIVE_BASE_PORT - 300, 2)
    t0 = time.perf_counter()
    stepper, agents, results = asyncio.run(run_cluster(cfg_d, None, 2))
    dumps = [r["chain_dump"] for r in results]
    blocks = dumps[0].splitlines()[1:]
    d = {"cell": "d_batch_stepper_n8", "peers": HIVE_CLUSTER_N,
         "device": str(stepper.device), "seconds": time.perf_counter() - t0,
         "chains_equal": all(x == dumps[0] for x in dumps),
         "rounds": len(blocks),
         "nonempty_blocks": sum("ndeltas=0" not in x for x in blocks),
         "batches": stepper.batches, "evals": stepper.evals, "chain": blocks}
    emit("hive", **d)
    if not (d["chains_equal"] and d["rounds"] == 2 and d["nonempty_blocks"] == 2
            and d["device"] == "cuda" and 1 <= d["batches"] <= 3):
        raise AssertionError(f"hive (d): the BatchStepper cluster failed: {d}")
    torch.cuda.synchronize()
    return {"b1_launches": c["b1_launches"],
            "live_pool_kernel": c["b1_on_the_live_pool"],
            "seconds": time.perf_counter() - t_phase}


def drivers_phase(dev) -> dict:
    """The slice-8 drivers on the card, cells (a)-(g) of the module
    docstring, each through the entry point a user calls; returns B1's
    launches in (a) and (b) and B2's in (c)."""
    import torch

    from biscotti_tpu_torch import bench
    from biscotti_tpu_torch.config import Defense
    from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl
    from biscotti_tpu_torch.crypto.kernels import cuda_validate as cv
    from biscotti_tpu_torch.eval import eval_krum_kernel, eval_sim_scale
    from biscotti_tpu_torch.ops import krum_cuda

    kern = krum_cuda.krum_scores_kernel
    platform = dev.type
    t_phase = time.perf_counter()

    # (a) B1 against the plain path across committee sizes
    t0 = time.perf_counter()
    kern.launches = 0
    rows = eval_krum_kernel.run(DRIVER_KRUM_SIZES, DRIVER_KRUM_D, dev)
    a_launches = kern.launches
    for r in rows:
        emit("drivers", cell="krum_kernel", **r)
    emit("drivers", cell="krum_kernel_done",
         seconds=time.perf_counter() - t0, b1_launches=a_launches)
    bad = [r for r in rows if not r["agree"]]
    if bad:
        raise AssertionError(f"B1 differs from the plain path: {bad}")

    # (b) the simulator's scale sweep; B1 once a round at N = 1024 only
    t0 = time.perf_counter()
    kern.launches = 0
    sim_rows = eval_sim_scale.run("mnist", DRIVER_SIM_SIZES, DRIVER_SIM_ROUNDS,
                                  dev)
    b_launches = kern.launches
    for r in sim_rows:
        emit("drivers", cell="sim_scale", **r)
    emit("drivers", cell="sim_scale_done",
         seconds=time.perf_counter() - t0, b1_launches=b_launches)
    for r in sim_rows:
        in_window = (krum_cuda.KERNEL_MIN_N <= r["contributors_per_round"]
                     <= krum_cuda.KERNEL_MAX_N)
        want = DRIVER_SIM_ROUNDS if r["nodes"] == 1024 else 0
        if r["krum_launches"] != want or in_window != (want > 0):
            raise AssertionError(f"sim_scale N={r['nodes']}: B1 launched "
                                 f"{r['krum_launches']} times, not {want}")
        if not (0.0 <= r["final_error"] < 0.9 and r["mean_accepted"] > 0):
            raise AssertionError(f"sim_scale N={r['nodes']}: {r}")

    # (c) the crypto-kernel entry: the card's msm = the native one
    t0 = time.perf_counter()
    b2_before = cv.oncurve_mask.launches
    cl.reset_launches()
    crypto = bench.bench_crypto_kernel(DRIVER_MSM_WIDTHS, device=dev)
    c_b2 = cv.oncurve_mask.launches - b2_before
    c_b3 = cl.launches()
    emit("drivers", cell="crypto_kernel", seconds=time.perf_counter() - t0,
         b2_launches=c_b2, b3_launches=c_b3, **crypto)
    if not all(r["results_equal"] for r in crypto.values()):
        raise AssertionError(f"the card's msm differs from the native: {crypto}")
    if c_b3["msm_ladder"] < 1 or c_b3["point_add"] < 1:
        raise AssertionError(f"the crypto entry's msm ran without B3a and "
                             f"B3d: {c_b3}")

    # (d) the migration entry at N = 100
    t0 = time.perf_counter()
    mig = bench.bench_migration(n=DRIVER_MIGRATION_N, iterations=2,
                                device=dev)
    emit("drivers", cell="migration", seconds=time.perf_counter() - t0, **mig)
    if not (mig.get("moves", 0) >= 1 and mig["chains_equal"]
            and "migration_downtime_s" in mig and "migration_bytes" in mig):
        raise AssertionError(f"migration entry: {mig}")

    # (e) one attack cell, hug × KRUM, at the matrix's operating point
    t0 = time.perf_counter()
    attack = bench.bench_attack_matrix(device=dev,
                                       cells=(("hug", Defense.KRUM),))
    emit("drivers", cell="attack_matrix", seconds=time.perf_counter() - t0,
         point=bench.ATTACK_POINT, **attack)
    cell = attack.get("hug_krum", {})
    if not (attack["complete"] and cell.get("chains_equal")):
        raise AssertionError(f"attack cell hug x KRUM: {attack}")

    # (f) one straggler row: 20 % slowed, adaptive deadlines
    t0 = time.perf_counter()
    plan, seed = bench.plan_for(0.20, 10)
    row = bench.straggler_case(plan, True, bench.STRAGGLER_PORT, n=10,
                               rounds=3, device=dev)
    emit("drivers", cell="straggler_slow20_adaptive",
         seconds=time.perf_counter() - t0, slow_seed=seed,
         slowed_peers=sorted(plan.slow_table(10)), **row)
    if not (row["chains_equal"] and row["real_blocks"] >= 1):
        raise AssertionError(f"straggler row: {row}")

    # (g) the local harness: peer processes of the port's CLI on the card
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "biscotti_tpu_torch.eval.local_test",
         "--nodes", str(DRIVER_LOCAL_PEERS), "--max-iterations", "2",
         "--convergence-error", "0", "--base-port", str(DRIVERS_LOCAL_PORT),
         "--timeout", "240", "--platform", platform],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    local = next((json.loads(l) for l in reversed(proc.stdout.splitlines())
                  if l.startswith("{")), None)
    emit("drivers", cell="local_test", seconds=time.perf_counter() - t0,
         rc=proc.returncode, summary=local,
         stderr_tail=proc.stderr.splitlines()[-5:])
    if not (proc.returncode == 0 and local and local["chains_equal"]
            and local["blocks"] > 0 and local["device"] != "cpu"):
        raise AssertionError(f"local_test: rc {proc.returncode}, {local}")

    torch.cuda.synchronize()
    emit("drivers", cell="done", seconds=time.perf_counter() - t_phase,
         b1_launches={"krum_kernel": a_launches, "sim_scale": b_launches},
         b2_launches_crypto_kernel=c_b2, b3_launches_crypto_kernel=c_b3)
    return {"b1_krum_kernel": a_launches, "b1_sim_scale": b_launches,
            "b2_crypto_kernel": c_b2, "b3_crypto_kernel": c_b3,
            "krum_by_n": {r["n"]: r for r in rows}}


def mesh_cell(mesh, name: str, model_name: str, rounds: int):
    """(a)/(b): the sharded round on a one-rank NCCL group at N = MESH_N,
    B1 once a round on the gathered pool, its last round held to the plain
    Krum mask, the single-device Simulator and (later, on the CPU) the CPU
    port; returns (row, what the CPU check needs, the per-round trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from biscotti_tpu_torch.multichip import held_bytes, sharded_rounds
    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.ops.krum import (accept_mask,
                                             default_num_adversaries,
                                             krum_scores)
    from biscotti_tpu_torch.parallel import mesh as pm
    from biscotti_tpu_torch.parallel.sim import (sharded_draws,
                                                 sharded_step_from_draws)

    kern = krum_cuda.krum_scores_kernel
    t_cell = time.perf_counter()
    sim, step, trace, round_ms, launches = sharded_rounds(
        mesh, model_name, MESH_N, rounds)
    b1_launches = sum(launches)
    n, f = MESH_N, default_num_adversaries(MESH_N)
    it = rounds
    w_in, w, mask, err = trace[-1]
    draws = sharded_draws(sim, it, sim.cfg.seed, range(n))
    _, noised = sim.local_updates(w_in, torch.arange(n, device=w.device),
                                  draws[0], draws[1])
    plain_mask = accept_mask(krum_scores(noised, f), n - f)
    single = sim.round_step_from_draws(w_in, sim.init_state()[1],
                                       torch.arange(n, device=w.device),
                                       *draws)
    again = sharded_step_from_draws(sim, mesh, sim.x, sim.y, w_in, *draws)
    torch.cuda.synchronize()
    w_tol = MESH_RTOL * float(single[0].abs().max())
    gates = {
        "b1_once_a_round": launches == [1] * rounds,
        "mask_is_plain_krum": bool(torch.equal(mask, plain_mask)),
        "mask_is_single_device": bool(torch.equal(mask, single[2])),
        "w_is_single_device": bool(torch.allclose(w, single[0], rtol=MESH_RTOL,
                                                  atol=w_tol)),
        "err_is_single_device": abs(float(err) - float(single[3]))
        <= MESH_RTOL * abs(float(single[3])),
        "step_from_draws_is_the_round": bool(
            torch.equal(again[0], w) and torch.equal(again[1], mask)),
        "w_finite": bool(torch.isfinite(w).all()),
        "accepted_n_minus_f": int(mask.sum()) == n - f,
        "holds_every_peer": sim.x.shape[0] == len(sim.peers) == n}
    got, ref = kern(noised, f), krum_cuda.krum_scores_plain(noised, f)
    b1 = {"n": n, "d": sim.num_params,
          "max_abs_err": float((got - ref).abs().max()),
          "max_rel_err": rel_err(got, ref),
          "accept_set_identical": accept_set(got, n - f) == accept_set(ref, n - f),
          **krum_times(noised, f)}
    gather_ms = time_ms(lambda: pm.all_gather(mesh, noised))
    psum_ms = time_ms(lambda: pm.psum(mesh, w))
    step_ms = time_ms(lambda: sharded_step_from_draws(
        sim, mesh, sim.x, sim.y, w_in, *draws))
    draws_ms = time_ms(lambda: sharded_draws(sim, it, sim.cfg.seed, range(n)))
    pw = w
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for pit in range(it + 1, it + 1 + MESH_PROFILE_ROUNDS):
            pw, _, _ = step(pw, pit)
        torch.cuda.synchronize()
    prof_host_ms = 1e3 * (time.perf_counter() - t0) / MESH_PROFILE_ROUNDS
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = (sum(e.self_device_time_total for e in on_device) / 1e3
                 / MESH_PROFILE_ROUNDS)
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]
    row = {"cell": name, "nodes": n, "params": sim.num_params,
           **held_bytes(sim), "rounds": rounds, "round_ms": round_ms,
           "round_ms_median": statistics.median(round_ms),
           "step_from_draws_ms": step_ms, "draws_ms": draws_ms,
           "all_gather_ms": gather_ms, "psum_ms": psum_ms,
           "pool_bytes": noised.numel() * noised.element_size(),
           "device_ms_per_round": device_ms,
           "profiled_host_ms_per_round": prof_host_ms,
           "device_idle_share": 1.0 - device_ms / statistics.median(round_ms),
           "kernels_per_round": sum(e.count for e in on_device)
           / MESH_PROFILE_ROUNDS,
           "top": [{"name": e.key[:80], "ms_per_round":
                    e.self_device_time_total / 1e3 / MESH_PROFILE_ROUNDS}
                   for e in top],
           "b1_launches": b1_launches, "b1_at_the_pool": b1,
           "accepted": int(mask.sum()), "error": float(err),
           "w_max_abs_diff_single_device": float((w - single[0]).abs().max()),
           "gates": gates, "seconds": time.perf_counter() - t_cell}
    cpu_inputs = (model_name, w_in.cpu(), tuple(t.cpu() for t in draws),
                  w.cpu(), mask.cpu(), float(err))
    return row, cpu_inputs, trace


def mesh_cpu_check(cpu_mesh, inputs) -> dict:
    """The CPU port's sharded step on a card round's draws: mask equal, w
    and the error at MESH_RTOL."""
    import torch

    from biscotti_tpu_torch.multichip import mesh_cfg
    from biscotti_tpu_torch.parallel.mesh import local_slice
    from biscotti_tpu_torch.parallel.sim import (Simulator,
                                                 sharded_step_from_draws)

    model_name, w_in, draws, w, mask, err = inputs
    t0 = time.perf_counter()
    sim = Simulator(mesh_cfg(model_name, MESH_N), device="cpu",
                    peers=local_slice(cpu_mesh, MESH_N))
    cw, cmask, cerr = sharded_step_from_draws(sim, cpu_mesh, sim.x, sim.y,
                                              w_in, *draws)
    w_tol = MESH_RTOL * float(cw.abs().max())
    return {"mask_equal": bool(torch.equal(cmask, mask)),
            "w_close": bool(torch.allclose(w, cw, rtol=MESH_RTOL, atol=w_tol)),
            "err_close": abs(err - float(cerr)) <= MESH_RTOL * abs(float(cerr)),
            "w_max_abs_diff": float((w - cw).abs().max()), "w_atol": w_tol,
            "err_card": err, "err_cpu": float(cerr),
            "seconds": time.perf_counter() - t0}


def mesh_phase(dev) -> dict:
    """The multi-device paths (slice 9) on the card: (a) the sharded round
    at mnist softmax and (b) at mnist_cnn width on a one-rank NCCL group,
    with the CPU port on the same draws over a one-rank gloo group; (c)
    `dryrun_multichip(1)`; (d) a 2-rank gloo group on the one card, the
    softmax cell's rounds equal to (a)'s. Leaves no process group set up.
    Returns B1's launches and its rows at the gathered pools."""
    import tempfile

    import torch
    import torch.distributed as dist

    from biscotti_tpu_torch.multichip import dryrun_multichip
    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.parallel import mesh as pm

    kern = krum_cuda.krum_scores_kernel
    t_phase = time.perf_counter()
    rows, cpu_inputs, traces = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as tmp:
        t0 = time.perf_counter()
        with pm.open_mesh("peers", dev, rank=0, world_size=1,
                          init_method=f"file://{tmp}/nccl") as mesh:
            backend = dist.get_backend()
            open_s = time.perf_counter() - t0
            for name, model_name, rounds in MESH_CELLS:
                kern.launches = 0
                rows[name], cpu_inputs[name], traces[name] = mesh_cell(
                    mesh, name, model_name, rounds)
        with pm.open_mesh("peers", "cpu", rank=0, world_size=1,
                          init_method=f"file://{tmp}/gloo") as cpu_mesh:
            for name in rows:
                rows[name]["cpu_port"] = mesh_cpu_check(cpu_mesh,
                                                        cpu_inputs[name])
    for name, row in rows.items():
        emit("mesh", backend=backend, group_open_s=open_s, **row)
        cpu = row["cpu_port"]
        bad = [k for k, v in row["gates"].items() if not v]
        bad += [f"cpu_port.{k}" for k in ("mask_equal", "w_close", "err_close")
                if not cpu[k]]
        if not row["b1_at_the_pool"]["accept_set_identical"] \
                or not row["b1_at_the_pool"]["max_rel_err"] < RTOL:
            bad.append("b1_vs_plain")
        if backend != ("nccl" if dev.type == "cuda" else "gloo"):
            bad.append(f"backend {backend}")
        if bad:
            raise AssertionError(f"mesh {name}: {bad}")

    # (c) the port's multi-device dry run on this card
    t0 = time.perf_counter()
    line = dryrun_multichip(1, device=dev.type)
    emit("mesh", cell="dryrun_multichip", seconds=time.perf_counter() - t0,
         summary=line)

    # (d) two ranks on the one card: NCCL refuses that, gloo takes CUDA
    # tensors; the softmax rounds must equal (a)'s
    mesh_gloo_cell(dev, [(w.cpu().numpy(), m.cpu().numpy())
                         for _, w, m, _ in traces[MESH_CELLS[0][0]]])

    if dist.is_initialized():
        raise AssertionError("the mesh phase left a process group set up")
    emit("mesh", cell="done", seconds=time.perf_counter() - t_phase,
         b1_launches={name: row["b1_launches"] for name, row in rows.items()})
    return {"b1_launches": sum(row["b1_launches"] for row in rows.values()),
            "b1_at": {name: row["b1_at_the_pool"] for name, row in rows.items()}}


def mesh_gloo_cell(dev, want) -> dict:
    """(d): the softmax cell's rounds on a 2-rank gloo group, both ranks on
    the one card, held to (a)'s (w, mask) a round, `want`; each rank holds
    its own MESH_N // 2 peers."""
    from biscotti_tpu_torch.multichip import rounds_on_rank
    from biscotti_tpu_torch.parallel import mesh as pm

    t0 = time.perf_counter()
    ranks = pm.spawn(rounds_on_rank, 2, dev.type, backend="gloo",
                     args=("", MESH_N, MESH_CELLS[0][2]))
    gloo = {"seconds": time.perf_counter() - t0,
            "devices": [r["device"] for r in ranks],
            "round_ms": [r["round_ms"] for r in ranks],
            "b1_launches": [r["b1_launches"] for r in ranks],
            "all_gather_ms": [r["all_gather_ms"] for r in ranks],
            "psum_ms": [r["psum_ms"] for r in ranks],
            **{key: [r[key] for r in ranks] for key in (
                "peers_held", "x_bytes", "y_bytes", "max_memory_allocated")},
            "masks_equal_a": all(np.array_equal(m, wm) for r in ranks
                                 for (_, m, _), (_, wm) in zip(r["trace"], want)),
            "w_max_abs_diff_a": max(float(np.abs(w - ww).max()) for r in ranks
                                    for (w, _, _), (ww, _) in zip(r["trace"], want))}
    gloo["w_close_a"] = all(
        np.allclose(w, ww, rtol=MESH_RTOL, atol=MESH_RTOL * np.abs(ww).max())
        for r in ranks for (w, _, _), (ww, _) in zip(r["trace"], want))
    emit("mesh", cell="gloo_two_ranks_one_card", **gloo)
    if not (gloo["masks_equal_a"] and gloo["w_close_a"] and all(
            l == [1] * MESH_CELLS[0][2] for l in gloo["b1_launches"])
            and gloo["peers_held"] == [MESH_N // 2] * 2):
        raise AssertionError(f"mesh (d): {gloo}")
    return gloo


def entry_phase() -> dict:
    """`multichip.entry()` on the card: the step on its own arguments twice,
    bit-identical, equal to the Simulator's `round_step(w, stake, 0)`, its
    host ms a call (median of 20, each ending in a synchronize), and B1
    launched no time (S = 16, below B1's window)."""
    import torch

    from biscotti_tpu_torch.multichip import entry
    from biscotti_tpu_torch.ops import krum_cuda

    kern = krum_cuda.krum_scores_kernel
    t0 = time.perf_counter()
    kern.launches = 0
    fn, args = entry()
    once, twice = fn(*args), fn(*args)
    torch.cuda.synchronize()
    launches = kern.launches
    sim = fn.__self__
    want = sim.round_step(args[0], args[1], 0)
    call_ms = []
    for _ in range(20):
        t1 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        call_ms.append(1e3 * (time.perf_counter() - t1))
    w, _, mask, err = once
    row = {"nodes": sim.cfg.num_nodes, "contributors": int(args[2].shape[0]),
           "params": sim.num_params,
           "devices": sorted({str(t.device) for t in args}),
           "bit_identical_twice": all(torch.equal(a, b)
                                      for a, b in zip(once, twice)),
           "equals_round_step": all(torch.equal(a, b)
                                    for a, b in zip(once, want)),
           "w_finite": bool(torch.isfinite(w).all()),
           "accepted": int(mask.sum()), "error": float(err),
           "call_ms": call_ms, "call_ms_median": statistics.median(call_ms),
           "b1_launches": launches, "seconds": time.perf_counter() - t0}
    emit("entry", **row)
    if not (row["bit_identical_twice"] and row["equals_round_step"]
            and row["w_finite"] and launches == 0
            and row["devices"] == ["cuda:0"]):
        raise AssertionError(f"entry: {row}")
    return row


def ladder_line(crypto: dict, secagg: dict, live: dict, chaos: dict,
                protocol: dict, acceptance: dict, matrices: dict,
                drivers: dict):
    """The kernels line's rows of B3a-B3d: launches on the main paths by
    phase (the crypto intake, secagg's armed intakes, the rounds of live
    (b), (d) and (e), of chaos (a), of protocol (a) and (b), of
    acceptance (a) and of matrices (d) beyond the peers' prewarms,
    drivers (c)'s msm), and
    the times and
    bound at the shape the settle gives each (B3a's 8,192 lanes, B3b's
    Pedersen comb at 1 x 512, B3c's verdicts of 64 x 7,850 cells, the
    instance `grid_sum` runs, B3d's ext_add of 7,850 pairs), the other
    shapes under `at` (B3c's with the points among them, and protocol's:
    (a)'s msm, tree and fold, (b)'s keyed Pedersen comb)."""
    rows = []
    for kid, (_, wrapper, replaces) in LADDER.items():
        by_phase = {"crypto": crypto["b3_launches"][wrapper],
                    "secagg": secagg["b3_launches"][wrapper],
                    "live": live["b3_launches"][wrapper],
                    "chaos": chaos["b3_launches"][wrapper],
                    "protocol": protocol["b3_launches"][wrapper],
                    "acceptance": acceptance["b3_launches"][wrapper],
                    "matrices": matrices["b3_launches"][wrapper],
                    "drivers": drivers["b3_crypto_kernel"][wrapper]}
        timed = crypto["ladder"][kid]
        main = timed[-1] if kid == "B3b" else timed[0]
        timed = timed + [protocol["shapes"][kid]]
        rows.append({
            "name": f"ed25519_{wrapper}", "id": kid, "route": "cuda",
            "source": "biscotti_tpu_torch/csrc/ed25519_ladder.cu",
            "replaces": replaces, "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase, "shape": main["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in timed),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "kernel_only_ms": main["kernel_only_ms"],
            "occupancy_bound_ms": main.get("occupancy_bound_ms"),
            "threads_a_lane": main.get("threads_a_lane"),
            "registers": main["registers"],
            "spill_stores": main["spill_stores"],
            "at": [{k: r.get(k) for k in ("shape", "ms", "kernel_only_ms",
                                           "plain_ms", "bound_ms", "bound_by",
                                           "occupancy_bound_ms", "registers",
                                           "spill_stores")}
                   for r in timed if r is not main]})
    return rows


def card_smi() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


ALONE = {"acceptance": (acceptance_phase, ACCEPT_CELLS),
         "matrices": (matrices_phase, MATRIX_CELLS)}


def phase_alone(phase: str, cells: str) -> int:
    """`python3 chip_smoke.py acceptance|matrices [CELLS]`: the three
    libraries built, one prewarm's B3 launches at the mnist width taken
    (the secagg phase's count), then the phase's `cells` (its letters of
    the module docstring, default ACCEPT_CELLS or MATRIX_CELLS) alone on
    the card and the card's name and power limit."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from biscotti_tpu_torch import _build
    from biscotti_tpu_torch.crypto import kernels
    from biscotti_tpu_torch.crypto.kernels import cuda_ladder as cl

    smi = card_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with ThreadPoolExecutor(len(_build.KERNELS)) as pool:  # one nvcc each
        list(pool.map(_build.build, _build.KERNELS))
    with crypto_switch(arm=True):
        kernels.prewarm(7850)
        prewarm_b3 = cl.launches()
    run, default = ALONE[phase]
    out = run(torch.device("cuda", 0), prewarm_b3, cells or default)
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from biscotti_tpu_torch import _build
    from biscotti_tpu_torch.config import BiscottiConfig, Defense
    from biscotti_tpu_torch.ops import krum_cuda
    from biscotti_tpu_torch.ops.krum import default_num_adversaries
    from biscotti_tpu_torch.parallel.sim import Simulator

    # 1. device ---------------------------------------------------------
    smi = card_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         peak_fp32_flops=PEAK_FP32_FLOPS, peak_bytes_per_s=PEAK_BYTES_PER_S)
    dev = torch.device("cuda", 0)

    # 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.KERNELS)) as pool:  # one nvcc each
        logs = dict(zip(_build.KERNELS, pool.map(_build.build, _build.KERNELS)))
    oncurve_sass = _build.sass_mix(_build.library_path("oncurve"),
                                   "oncurve_kernel")
    krum_sass = _build.sass_mix(_build.library_path("krum_scores"),
                                "krum_gram_kernel")
    report = _build.ptxas_report(logs["ed25519_ladder"])
    ladder = {"ptxas": {k: ptxas_of(report, fn)
                        for k, (fn, _, _) in LADDER.items()},
              "layout": layout(_build.source("ed25519_ladder").read_text())}
    emit("build", seconds=time.perf_counter() - t0,
         sources=[str(_build.source(k).relative_to(_build.PKG.parent))
                  for k in _build.KERNELS],
         ptxas={k: [l.strip() for l in log.splitlines()
                    if "registers" in l or "spill" in l]
                for k, log in logs.items()},
         ladder_ptxas=ladder["ptxas"], ladder_layout=ladder["layout"],
         oncurve_sass=oncurve_sass, krum_gram_sass=krum_sass,
         krum_gram_pipes={op: sum(c for o, c in krum_sass.items()
                                  if o.split(".")[0] == op)
                          for op in ("FFMA", "HMMA")}
         if isinstance(krum_sass, dict) else krum_sass)
    for kid in LADDER:  # every instance of every ladder kernel keeps its
        if ladder["ptxas"][kid].get("spill_stores") != 0:  # values in
            raise AssertionError(f"{kid} spills: {ladder['ptxas'][kid]}")

    # 3. kernel vs plain --------------------------------------------------
    kern, plain = krum_cuda.krum_scores_kernel, krum_cuda.krum_scores_plain
    gen = torch.Generator(device=dev).manual_seed(0)

    def compare(case: str, x, check_accept: bool = False,
                check_exact: bool = False):
        n, d = x.shape
        f = default_num_adversaries(n)
        got, ref = kern(x, f), plain(x, f)
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        row = {"case": case, "n": n, "d": d, "max_rel_err": err,
               "max_abs_err": float((got - ref).abs().max()),
               "boundary_rel_gap": boundary_rel_gap(ref, n - f),
               **krum_times(x, f)}
        if check_accept:
            same = accept_set(got, n - f) == accept_set(ref, n - f)
            row["accept_set_identical"] = same
        if check_exact:  # each version against float64 throughout
            truth = krum_scores_fp64(x, f)
            row["kernel_vs_fp64_rel_err"] = rel_err(got.double(), truth)
            row["plain_vs_fp64_rel_err"] = rel_err(ref.double(), truth)
            row["rel_err_over_half_gap"] = err / (row["boundary_rel_gap"] / 2)
        emit("kernel", **row)
        if not err < RTOL:
            raise AssertionError(f"krum kernel disagrees at {case}: {err}")
        if check_accept and not row["accept_set_identical"]:
            raise AssertionError(f"krum kernel accept set differs at {case}")
        # where fp32 itself cannot resolve the boundary (the plain
        # version's own error exceeds half the gap), the kernel must be as
        # exact as the plain version: 10 % covers their two summation
        # orders
        if check_exact and not (row["kernel_vs_fp64_rel_err"]
                                <= EXACT_SLACK * row["plain_vs_fp64_rel_err"]):
            raise AssertionError(f"krum kernel is less exact than its plain "
                                 f"version at {case}")
        return row

    for n, d in KERNEL_SHAPES:
        compare(f"normal_{n}x{d}",
                torch.randn(n, d, generator=gen, device=dev))
    x = torch.randn(716, 7850, generator=gen, device=dev)
    x[10:40] = x[10]  # 30 identical rows: exact ties at the k-th threshold
    compare("duplicate_ties_716x7850", x)
    x = torch.randn(140, 48, generator=gen, device=dev)
    x[100:] += 25.0  # 40 outliers, as tests/test_krum_pallas.py
    compare("poison_cluster_140x48", x, check_accept=True)
    # rows that share one large mean: D ~ 39 next to |x|^2 ~ 7850, so
    # sq_i + sq_j - 2G cancels most of its digits
    x = 0.05 * torch.randn(716, 7850, generator=gen, device=dev) \
        + torch.randn(1, 7850, generator=gen, device=dev)
    compare("cancellation_716x7850", x, check_accept=True, check_exact=True)
    # ROADMAP C1: non-finite rows at the main path's n
    for case, (row, value) in {"overflow_2e19": (2, 2e19),
                               "plus_inf": (2, float("inf")),
                               "minus_inf": (300, float("-inf")),
                               "nan_input": (9, float("nan"))}.items():
        x = torch.randn(716, 7850, generator=gen, device=dev)
        x[row, 5] = value
        emit("kernel", **nonfinite_case(case, x, default_num_adversaries(716)))
    # ROADMAP C2: x1e-20 rows, every product subnormal. The reference
    # flushes subnormals, so its distances are all 0 and it accepts the
    # n - f lowest indices; B1, the plain path on the card and on the CPU
    # must all give exactly that
    x = 1e-20 * torch.randn(716, 7850, generator=gen, device=dev)
    sub = nonfinite_case("subnormal_1e-20", x, default_num_adversaries(716))
    keep = 716 - default_num_adversaries(716)
    sub["accept_set_is_reference"] = accept_set(
        kern(x, default_num_adversaries(716)), keep) == set(range(keep))
    emit("kernel", **sub)
    if not sub["accept_set_is_reference"]:
        raise AssertionError(f"B1 on x1e-20 rows is not the reference's "
                             f"accept set: {sub}")

    # 4. main path ------------------------------------------------------
    cfg = BiscottiConfig(dataset="mnist", num_nodes=1024, sample_percent=0.70,
                         defense=Defense.KRUM, verification=True, noising=True,
                         epsilon=1.0, batch_size=10, poison_fraction=0.3,
                         seed=0)
    t0 = time.perf_counter()
    sim = Simulator(cfg)
    setup_s = time.perf_counter() - t0
    s = cfg.num_samples
    f = default_num_adversaries(s)
    w, stake = sim.init_state()
    for it in range(2):  # warm rounds
        w, stake, mask, err = sim.round_step(w, stake, it)
    torch.cuda.synchronize()
    kern.launches = 0
    round_ms = []
    for it in range(2, 7):
        before = kern.launches
        t0 = time.perf_counter()
        w, stake, mask, err = sim.round_step(w, stake, it)
        torch.cuda.synchronize()
        round_ms.append(1e3 * (time.perf_counter() - t0))
        if kern.launches - before != 1:
            raise AssertionError(f"round {it} launched the Krum kernel "
                                 f"{kern.launches - before} times, not once")
    main_launches = kern.launches
    final_err = float(err)
    moved = (stake - cfg.default_stake).abs()
    emit("main", nodes=cfg.num_nodes, contributors=s, params=sim.num_params,
         setup_s=setup_s, round_ms=round_ms,
         round_ms_median=statistics.median(round_ms),
         krum_launches=main_launches, accepted=int(mask.sum()),
         final_error=final_err, max_stake_move=int(moved.max()))
    if not (w.shape == (sim.num_params,) and bool(torch.isfinite(w).all())):
        raise AssertionError("main path: w is not finite or has the wrong shape")
    if int(mask.sum()) != s - f:
        raise AssertionError(f"main path: {int(mask.sum())} accepted, not {s - f}")
    if not 0.0 <= final_err < 0.9:
        raise AssertionError(f"main path: test error {final_err} is no better "
                             "than chance")
    if int(moved.max()) > 7 * cfg.stake_unit or bool((moved % cfg.stake_unit).any()):
        raise AssertionError("main path: stakes moved off the ±stake_unit grid")

    # where the round's time goes: device kernels over a profiled window
    from torch.profiler import ProfilerActivity, profile

    prof_rounds = 3
    pw, pstake = w, stake
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for it in range(7, 7 + prof_rounds):
            pw, pstake, _, _ = sim.round_step(pw, pstake, it)
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3 / prof_rounds
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]
    emit("profile", rounds=prof_rounds, device_ms_per_round=device_ms,
         device_idle_share=1.0 - device_ms / statistics.median(round_ms),
         kernels_per_round=sum(e.count for e in on_device) / prof_rounds,
         top=[{"name": e.key[:100],
               "ms_per_round": e.self_device_time_total / 1e3 / prof_rounds,
               "calls_per_round": e.count / prof_rounds} for e in top])

    # 5. card vs CPU on the same draws, and the kernel on main-path inputs
    draws = sim.draw_round(sim.gen, 7)
    cidx, batch_idx, noise, keep = draws
    _, noised = sim.local_updates(w, cidx, batch_idx, noise)
    got, ref = kern(noised, f), plain(noised, f)
    main_kernel = {
        "max_abs_err": float((got - ref).abs().max()),
        "max_rel_err": rel_err(got, ref),
        "accept_set_identical": accept_set(got, s - f) == accept_set(ref, s - f),
        "boundary_rel_gap": boundary_rel_gap(ref, s - f),
        **krum_times(noised, f)}
    c1 = {}
    for case, cells in (("overflow_2e19", [(2, 5, 2e19)]),
                        ("plus_and_minus_inf", [(3, 7, float("inf")),
                                                (9, 1, float("-inf"))])):
        x = noised.clone()
        for r, c, v in cells:
            x[r, c] = v
        c1[case] = nonfinite_case(case, x, f)
    main_kernel["nonfinite"] = c1
    # ROADMAP C2 on main-path inputs: the round's updates scaled to a
    # largest |x| of 1e-20, so every product is subnormal (B1 = plain = the
    # reference's accept set, the s - f lowest ids)
    tiny = noised * (1e-20 / float(noised.abs().max()))
    c2 = nonfinite_case("subnormal_1e-20", tiny, f)
    c2["accept_set_is_reference"] = accept_set(kern(tiny, f), s - f) \
        == set(range(s - f))
    main_kernel["subnormal"] = c2
    if not c2["accept_set_is_reference"]:
        raise AssertionError(f"B1 on main-path updates x1e-20 is not the "
                             f"reference's accept set: {c2}")
    gpu = sim.round_step_from_draws(w, stake, *draws)
    cpu_sim = Simulator(cfg, device="cpu")
    cpu = cpu_sim.round_step_from_draws(w.cpu(), stake.cpu(),
                                        *(t.cpu() for t in draws))
    w_gpu, w_cpu = gpu[0].cpu(), cpu[0]
    w_tol = 1e-4 * float(w_cpu.abs().max())
    parity = {"mask_equal": bool(torch.equal(gpu[2].cpu(), cpu[2])),
              "stake_equal": bool(torch.equal(gpu[1].cpu(), cpu[1])),
              "w_max_abs_diff": float((w_gpu - w_cpu).abs().max()),
              "w_atol": w_tol, "err_gpu": float(gpu[3]), "err_cpu": float(cpu[3])}
    emit("parity", main_path_kernel=main_kernel, **parity)
    if not main_kernel["max_rel_err"] < RTOL or not main_kernel["accept_set_identical"]:
        raise AssertionError("krum kernel disagrees with plain on main-path inputs")
    # a score error as large as half the boundary gap could flip the accept
    # set: a near-tie shows here, not as a later mask mismatch
    if not main_kernel["max_rel_err"] < main_kernel["boundary_rel_gap"] / 2:
        raise AssertionError("krum kernel error is not below half the score gap "
                             "at the accept boundary on main-path inputs")
    if not (parity["mask_equal"] and parity["stake_equal"]):
        raise AssertionError("card and CPU rounds disagree on mask or stake")
    if not torch.allclose(w_gpu, w_cpu, rtol=RTOL, atol=w_tol):
        raise AssertionError("card and CPU rounds disagree on w")

    # crypto_kernel, crypto: the device crypto plane and kernel B2 --------
    grid, a, b = valid_grid(seed=0)
    b2 = crypto_kernel_phase(dev, grid, oncurve_sass)
    crypto = crypto_phase(dev, grid, a, b, ladder)
    secagg = secagg_phase(dev)

    # models, defenses, cnn, bench, trainer: slice 3 ------------------------
    models_phase(dev)
    defenses = defenses_phase(dev)
    cnn = cnn_phase(dev)
    bench_phase(dev)
    trainer_phase(dev)
    cnn_kernel = cnn["kernel"]

    # ledger: slice 5, the card's rounds sealed and sent --------------------
    ledger = ledger_phase(dev, sim, w, stake, cnn.pop("ledger_rows"),
                          first_round=7 + prof_rounds)

    # live: slice 6, clusters of port peers on the card --------------------
    live = live_phase(secagg["b3_launches_prewarm"])

    # chaos: the chaos CLI's fault, overload, churn and campaign planes ----
    chaos = chaos_phase(secagg["b3_launches_prewarm"])

    # protocol: the keyed and CNN-width secure aggregation armed, codecs --
    protocol = protocol_phase(dev, ladder, oncurve_sass,
                              secagg["b3_launches_prewarm"])

    # acceptance: the reference's slow acceptance drills on the card ------
    acceptance = acceptance_phase(dev, secagg["b3_launches_prewarm"])

    # matrices: the last slow drills and one soak cycle on the card --------
    matrices = matrices_phase(dev, secagg["b3_launches_prewarm"])

    # hive: slice 7, co-hosted port peers on the card -----------------------
    hive = hive_phase(dev)

    # drivers: slice 8, the eval drivers and the bench's other entries ------
    drivers = drivers_phase(dev)

    # mesh: slice 9, the sharded paths on torch.distributed -----------------
    mesh = mesh_phase(dev)

    # entry: the counterpart of __graft_entry__.py::entry on the card -------
    entry_phase()

    # 6. kernels ----------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "krum_scores", "route": "cuda",
        "source": "biscotti_tpu_torch/csrc/krum_scores.cu",
        "replaces": "biscotti_tpu/ops/krum_pallas.py:72",
        "launches": (main_launches + defenses["b1_launches"]
                     + cnn["b1_launches"] + ledger["b1_launches"]
                     + acceptance["b1_launches"] + matrices["b1_launches"]
                     + hive["b1_launches"]
                     + drivers["b1_krum_kernel"] + drivers["b1_sim_scale"]
                     + mesh["b1_launches"]),
        "launches_by_phase": {"main": main_launches,
                              "defenses": defenses["b1_launches"],
                              "cnn": cnn["b1_launches"],
                              "ledger": ledger["b1_launches"],
                              "acceptance": acceptance["b1_launches"],
                              "matrices": matrices["b1_launches"],
                              "hive": hive["b1_launches"],
                              "drivers_krum_kernel": drivers["b1_krum_kernel"],
                              "drivers_sim_scale": drivers["b1_sim_scale"],
                              "mesh": mesh["b1_launches"]},
        "max_abs_err": main_kernel["max_abs_err"],
        "ms": main_kernel["ms"], "plain_ms": main_kernel["plain_ms"],
        "bound_ms": main_kernel["bound_ms"], "bound_by": main_kernel["bound_by"],
        "library_ms": None, "bound_pipe": main_kernel["bound_pipe"],
        "kernel_only_ms": main_kernel["kernel_only_ms"],
        "gram_cublas_ms": main_kernel["gram_cublas_ms"],
        "at_716x164266": {k: cnn_kernel[k] for k in (
            "max_abs_err", "ms", "kernel_only_ms", "plain_ms", "gram_cublas_ms",
            "bound_ms", "bound_by", "accept_set_identical")},
        "at_the_hive_live_pool": {k: hive["live_pool_kernel"][k] for k in (
            "n", "d", "max_abs_err", "ms", "kernel_only_ms", "plain_ms",
            "gram_cublas_ms", "bound_ms", "bound_by",
            "accept_set_identical")},
        "at_the_mesh_pools": {name: {k: r[k] for k in (
            "n", "d", "max_abs_err", "ms", "kernel_only_ms", "plain_ms",
            "gram_cublas_ms", "bound_ms", "bound_by", "accept_set_identical")}
            for name, r in mesh["b1_at"].items()},
        "by_committee_size": {n: {k: r[k] for k in (
            "kernel_ms", "kernel_only_ms", "plain_ms", "gram_cublas_ms",
            "bound_ms", "bound_by", "max_abs_err", "max_rel_err",
            "accept_set_equal")} for n, r in drivers["krum_by_n"].items()}}, {
        "name": "oncurve_validate", "route": "cuda",
        "source": "biscotti_tpu_torch/csrc/oncurve.cu",
        "replaces": "biscotti_tpu/crypto/kernels/pallas_validate.py:34",
        "launches": (crypto["oncurve_launches"] + secagg["b2_launches"]
                     + live["b2_launches"] + chaos["b2_launches"]
                     + protocol["b2_launches"]
                     + acceptance["b2_launches"]
                     + matrices["b2_launches"]
                     + drivers["b2_crypto_kernel"]),
        "launches_by_phase": {"crypto": crypto["oncurve_launches"],
                              "secagg": secagg["b2_launches"],
                              "live": live["b2_launches"],
                              "chaos": chaos["b2_launches"],
                              "protocol": protocol["b2_launches"],
                              "acceptance": acceptance["b2_launches"],
                              "matrices": matrices["b2_launches"],
                              "drivers": drivers["b2_crypto_kernel"]},
        "max_abs_err": max(b2["max_abs_err"],
                           protocol["shapes"]["B2"]["max_abs_err"]),
        "ms": b2["ms"], "plain_ms": b2["plain_ms"],
        "bound_ms": b2["bound_ms"], "bound_by": b2["bound_by"],
        "library_ms": None,
        "at_the_cifar_cnn_fold": {k: protocol["shapes"]["B2"][k] for k in (
            "shape", "ms", "kernel_only_ms", "plain_ms", "bound_ms",
            "bound_by")}}] + ladder_line(crypto, secagg, live, chaos,
                                          protocol, acceptance, matrices,
                                          drivers)}),
        flush=True)
    print(smi, flush=True)  # the card's name and power limit, verbatim
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] and sys.argv[1] in ALONE:
        raise SystemExit(phase_alone(sys.argv[1], "".join(sys.argv[2:])))
    raise SystemExit(main())
