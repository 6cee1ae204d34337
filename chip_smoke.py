"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py                    # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases kernel    # only the kernel-vs-plain check

Phases (any failure exits non-zero; no phase's exception is swallowed):

  reference  a small term-free auction on the card equals the same auction
             on the CPU (the plain path the CPU tests tie to the JAX
             package), every GangResult field, under both backends, and
             with a host score bias on the pallas route (K1's bias
             plane); the gang auction with intra-batch topology on a
             seeded world with every default family live
             (kubetpu_torch/harness/seq_worlds.py: 1,000 nodes x 512
             pods, random host_ok and score_bias), at full width and with
             a 64-row window, equals the CPU's run, every GangResult
             field; and the sequential replay on the same world (adaptive
             sampling, start index 37) equals the CPU's run, every
             SeqResult field; every plane shared; and two preemption
             drains, card against CPU, with the same deleted victims in
             the same order, the same nominations and the same placements:
             scheduler_perf's Preemption (500 nodes packed with 2,000
             low-priority fillers, 500 preemptors) under the default
             configuration (the sequential replay, every scan under
             "error"; the DecisionLog equal card vs CPU, pod by pod), and
             a term-bearing preemption world
             (kubetpu_torch/harness/preempt_worlds.py: 48 nodes, 16
             preemptors, PDBs, parked nominations) in gang mode under
             "pallas", whose what-ifs take the per-pod reprieve (its ms
             per call reported);
  kernel     the CUDA propose kernel equals its plain PyTorch version
             bitwise (prop/act/best) on seeded worlds at the slice's shapes
             (W=1024 rows, and a W=512 window with sentinel rows of a
             1,024-row bundle, x N=8192 nodes, with all-infeasible rows and
             hostPort conflicts), under both instantiations (the default
             plugin family, and a generic layout with a bias plane), and on
             worlds that take the kernel's size-selected branches (16
             zones; N=20480 above the shared-memory staging threshold;
             ragged N) and its exact-division recompute (operands outside
             the fast division's range); checks the fast division against
             __fdiv_rn on 2**28 operand pairs; prints its time, the plain
             version's time, the bound and the share of the bound, the
             generic combine's time at the same W x N (the
             ClusterAutoscaler profile's scores, between two timings of
             the default family), and the SM clock and power draw under
             load;
  slice      SchedulingBasic5000Nodes (scheduler_perf): 5,000 nodes, 5,000
             initial pods (one per node), 1,000 term-free pending pods,
             batch_size 1,000, mode gang, kernel_backend pallas, drained
             through Scheduler.schedule_pending.  Every pod placed, no
             capacity violated.  On identical nodes every pod's round-0
             proposal fits, so the cycle ends after the round-0 (plain)
             round and the kernel does not launch here — as in the JAX
             package, whose Pallas kernel also starts at round 1;
  backlog    a constructed stress case at the JAX bench's default shape,
             1,000 nodes x 4,096 pending pods, with traffic chosen to
             contend (900m pods, nodes carrying 0-3 existing pods; the
             bench's own default is 100m pods, 2 per node): pods crowd
             onto the least-loaded nodes, so many rounds run.  Drained
             under "pallas" and under "lax" on the card: identical
             placements;
  fill       Preemption5000Nodes' init phase (scheduler_perf): 20,000
             low-priority 900m fillers onto 5,000 empty nodes, which they
             fill exactly (four per node), batch_size 1,000, gang.  The
             last batches find one free slot per node and contend.
             Drained under "pallas" and "lax": every pod placed, four per
             node, identical placements; and a third time under "pallas"
             with a full build every cycle (chaining off and a
             DeltaTensorizer with resync interval 0, the port's path
             before the resident cluster): the same placements; and a
             fourth under "pallas" with delta refreshes every cycle and
             no chain (chain_cycles off, the default DeltaTensorizer):
             the same placements, so the chain's own share shows.  Each
             drain reports its tensorize and upload seconds, chain uses
             and the source of every cycle's cluster (chain, delta or a
             resync reason), and the third and fourth hold their first
             16 K1 launches against the plain version;
  preempt    Preemption5000Nodes' measured phase (config/performance-
             config.yaml:163-171): the fill's end state (20,000 900m
             fillers at priority -10, four on each of 5,000 nodes, bound
             directly: the fill phase drains the same packing) and 5,000
             preemptors (600m, 250 Mi, priority 100,
             kubetpu/harness/perf.py:111-116), drained in gang mode under
             "pallas", batch 1,000, through the PostFilter wave and the
             nominated-pods overlay.  Every preemptor bound, every evicted
             pod a lower-priority filler, none deleted twice, no capacity
             violated, no wave failed; every auction under "error".
             Reports cycles, waves, wave rounds, evictions, device reads
             per wave, the stages (with "preempt"), the what-if's device
             ms per wave and K1's launches (recorded and held against the
             plain version).  Every pod failing the first cycle has a
             PodDecision whose rejections name NodeResourcesFit; the
             decision audit's stream ms per failure cycle (CUDA events
             around the call: host launch gaps included) and its failed
             and valid rows per call are reported.
             The drain runs again with a full build every cycle: the same
             evictions and placements, its tensorize and upload seconds
             beside the delta/chained drain's;
  seq_slice  SchedulingBasic5000Nodes under the default configuration: mode
             sequential (the replay, models/sequential.py), adaptive
             sampling (500 of 5,000 nodes per pod), batch 1,000.  Every
             pod placed, no capacity violated; and the same world drained
             with device="cpu" (in a child process started with the run,
             since the CPU replay costs ~45 s per 1,000 pods): the same
             placements of all 1,000 pods and the same final start index
             (the CPU's time reported);
  seq_anti   SchedulingPodAntiAffinity5000Nodes (scheduler_perf
             config/performance-config.yaml:20-26): 5,000 nodes, 1,000
             init pods bound one per node on every fifth node (a cut: the
             benchmark schedules them), 1,000 pending pods with required
             hostname anti-affinity on app-{i % 1000}
             (kubetpu/harness/perf.py:146-148), init pods alike.  Every
             pod placed, no two pods of one app on a node, no capacity
             violated;
  seq_spread TopologySpreading5000Nodes (:120-125): 5,000 nodes in 8 zones,
             5,000 init pods bound one per node (a cut, as above), 2,000
             pending pods with a DoNotSchedule zone constraint, max_skew 2
             over group: measured (perf.py:169-172).  Every pod placed, the
             measured group's zone skew at most 2, no capacity violated;
  gang_anti  SchedulingPodAntiAffinity5000Nodes (the seq_anti world and
             cut) in gang mode under "pallas", batch 1,000: the batch
             needs intra-batch topology, so the cycle runs the lax round
             (route recorded, K1 not launched).  Every pod placed, no two
             pods of one app on a node, no capacity violated;
  gang_spread TopologySpreading5000Nodes (the seq_spread world and cut) in
             gang mode under "pallas", batch 1,000: two cycles, each
             windowed (B = 1,024 > 512), lax round.  Every pod placed,
             zone skew at most 2, no capacity violated; ms per round;
  autoscaler Preemption5000Nodes' init phase (the fill's world: 5,000
             nodes, 20,000 900m fillers, batch 1,000, gang) under
             upstream's ClusterAutoscalerProvider profile
             (NodeResourcesLeastAllocated disabled, MostAllocated enabled
             at weight 1), drained under "pallas" and "lax": every filler
             placed, identical placements, no capacity violated; K1 runs
             its generic combine (the descriptor walk) and never the
             compiled-in default family; its first 16 launches recorded
             and held against the plain version;
  binpack    SchedulingBasic5000Nodes under a bin-packing profile (the
             default set plus RequestedToCapacityRatio with the plugin's
             default arguments and NodeResourceLimits): the sequential
             replay on the card (every scan under "error"), held against
             the CPU replay of the world (as seq_slice's): same
             placements and start index; launches and device ms per
             scan step over a profiled window of 128 steps; the same world
             in gang mode under "pallas", routed to the lax round as
             "score:RequestedToCapacityRatio" (route checked);
  points     kubetpu_torch/harness/plugin_worlds.py's world (48 nodes x
             200 pods, seed 7) under its profile (the NodeLabel filter,
             MostAllocated, ServiceAffinity, a recording plugin at every
             extension point with a host filter, a host score, Permit
             pairs and an injected Reserve, Permit and PreBind failure;
             term-bearing: also RequestedToCapacityRatio,
             NodeResourceLimits and the NodeLabel score, pod terms and a
             Service), term-free and term-bearing, gang under "pallas" and
             sequential, binding on the binder pool, card against CPU: the
             same placements, the same per-pod extension-point calls, the
             same Unreserve calls and forgotten assumes, the Permit pairs
             bound; the term-free gang drains launch K1 with the host_ok
             and bias planes, every launch held against the plain version;
  volumes    the volume family (kubetpu_torch/state/volumes.py): on eight
             seeded worlds (harness/volume_worlds.py, 64 nodes x 128
             pods) the card's [B, N] volume mask equals the CPU's bitwise
             and the host plugins' verdicts on every (pod, node);
             scheduler_perf's SchedulingSecrets, SchedulingInTreePVs,
             SchedulingMigratedInTreePVs and SchedulingCSIPVs
             (config/performance-config.yaml:27-70: 500 nodes, the 500
             init pods bound one per node (a cut), 1,000 measured pods)
             under the default configuration (sequential, batch 256), and
             the PV and CSI ones also in gang mode under "pallas" (batch
             1,000), card against CPU: the same placements, claims
             (volume, selected-node stamp) and failure messages;
             vol_backlog (the backlog's shape, every pod mounting one
             bound, zone-pinned CSI volume under CSINode limits of 4-6),
             gang under "pallas", card against CPU, K1 launched with the
             volume mask in host_ok and its first 16 launches held
             against the plain version; the four workloads at 5,000
             nodes (:32-70, the same cut) on the card, sequential and
             gang under "pallas" at batch 1,000: all 1,000 bound, no
             capacity or attach limit violated, and the mask of 8 sampled
             pods equal to the host plugins on all 5,000 nodes.  Drains
             run on an advanced queue clock (volume_drain), so the card
             and the CPU retry the same pods; each reports its stages,
             the overlay's host s and the mask's device ms per cycle, ms
             per scan step or per round, and K1's launches;
  resident   the resident cluster under churn (resident_world: nodes
             with three 900m fillers each, waves of 900m pods and 2,000m
             preemptors that must evict, and cluster events between
             cycles: external binds, deletions, node label updates, a new
             taint, a node added): 5,000 nodes gang under "pallas" (batch
             500, chained cycles and delta refreshes, K1 counted and
             every launch held against the plain version) and
             sequential (batch 100), after every refresh verify() (the
             card's resident fingerprint against the host mirror's)
             holding; the same sequence at 1,000 nodes in both modes on
             the card and on the CPU: the same placements and evictions,
             the same cluster source every cycle, and per refresh the
             same outcome, pod_uid_list and resident bytes (sha256);
  serving    the serving loop (Scheduler's pipelined executor, cycle
             recovery, Scheduler.run, the HTTP server, the CLI and the
             REST store).  The fill (Preemption5000Nodes' init phase,
             5,000 nodes, 20,000 fillers, gang under "pallas", batch
             1,000, chain on) drained synchronously and pipelined at
             depths 1, 2 and 4, once each (twice before the extenders
             and chaos phases joined the run's time limit), with the dispatch deadline
             armed (10 s): every drain binds the same pod -> node map,
             launches K1 as often as the synchronous drain, every launch
             recorded and held against the plain version; the depth-4
             ring reaches 3 parked cycles; per drain the seconds, stages,
             host-exempt seconds, cycles and re-runs.  vol_backlog (batch
             1,024, so a volume batch finds cycles in flight and flushes
             them first) pipelined at depth 2 equals its synchronous
             drain.  Every drain runs on a frozen queue clock in passes
             (serve_passes).  Two
             injected faults in the backlog's 1,000-node world: at depth
             2 the third auction raises, and at depth 3 with a 2 s
             deadline the first auction stalls 3 s; each recovery
             recorded with its reason, no demotion (every cycle before
             and after it on the kernel route), the cycle's pods
             requeued, after the stall the younger cycle re-run, every
             pod bound exactly once, four per node, no capacity
             violated.  Scheduler.run and
             SchedulerServer on 5,000 hollow nodes with 5,000 pending
             pods and one that fits nowhere (depth 2, binding on the
             pool): every pod bound within a bound, /healthz, /metrics
             and /debug/explain answer, close() within 10 s.  ``python -m
             kubetpu_torch --once`` on 5,000 hollow nodes and pods with a
             pipelined configuration binds what the same in-process drain
             binds.  The REST store in two processes: one serves
             1,000 hollow nodes and 2,000 pods through APIServer, ``python
             -m kubetpu_torch --api-server URL --once`` schedules them,
             and the serving process's store sees every binding (the CLI
             and REST checks run in the card child, beside the earlier
             phases);
  extenders  HTTP extenders (kubetpu_torch/extender.py, the Scheduler's
             extender path): SchedulingBasic5000Nodes (5,000 nodes, one
             bound pod each, its 1,000 measured pods) under the
             default configuration with an in-process fake extender on
             127.0.0.1 (harness/extender_worlds.py: its filter drops every
             node whose index is a multiple of 4, its prioritize scores
             crc32(pod/node) % 11, its bind binds through the store):
             every pod its own cycle, scored on the card and placed on the
             host; all 1,000 bound, none on a filtered node, each bound by
             the extender, one Scheduled Event each.  Eight pairs of
             cycles spread over the drain (EXT_REPLAY_AT: 0-1, 142-143,
             ..., 998-999) are replayed on the CPU, each from the card's
             state before it (the pods of the earlier cycles bound where
             the card bound them, the tie-break counter as the card's;
             the CPU's filter-and-score at N = P = 8,192 costs seconds per
             pod): the same nodes and PodDecisions, their extenders maps
             included, and the same counters after each cycle.  And
             scheduler_perf's Preemption (:158-162: 500 nodes packed with
             2,000 fillers bound directly, 500 preemptors) with a
             preemptVerb extender that keeps only the even-indexed
             candidates, card against the whole CPU drain: the same
             victims in order, nominations, placements and decisions;
             preemption_attempts_total and the preemption_victims count
             and sum equal to the drain's own tallies, one Preempted
             Event per eviction.  Reports cycles, seconds, stages and
             extender round trips per pod;
  journal    the cycle journal and its replayer (utils/journal.py,
             kubetpu_torch.kubereplay) and devstats (utils/devstats.py):
             the fill (Preemption5000Nodes' init, config/performance-
             config.yaml:163-171: 5,000 nodes, 20,000 fillers, gang under
             "pallas", batch 1,000, the chain on, pipelined at depth 2)
             with the journal, devstats at sample interval 1 and, once the
             first 3 records are on disk, the chaos point
             journal:truncate:n=1 armed: placements equal to the fill
             phase's disarmed drain; the whole journal replayed on the
             card, every record bit-matched but the truncated one and the
             broken lineage behind it up to the next resync anchor, every
             K1 launch of the replay recorded and held bitwise to the
             plain version; the first 3 records replayed on the CPU in
             the reference child beside the later phases (collected after
             the last phase).  Reports each program's device time from
             CUDA event pairs, fence_wait_s, run_auction's roofline
             fraction against 67e12 f32 FLOP/s (below 1.05), and the
             ledger's resident bytes against memory_allocated's rise at
             each upload;
  chaos      fault injection (utils/chaos.py), armed through
             KUBETPU_CHAOS as an operator arms it: the backlog's world
             (1,000 nodes x 4,096 pods, gang under "pallas", batch 512,
             the chain on) with KUBETPU_VERIFY_INTERVAL=1 and
             "seed=42,dispatch:error:n=1,delta:corrupt:n=1,bind:error:n=1":
             every armed point fired, faults_injected equal to the fire
             counts, recovery_log holding dispatch-error and
             verify-resync and nothing else, one bind retry counted (with
             its BindRetried Event), every pod bound exactly once, the
             kernel route kept, every K1 launch recorded and held bitwise
             to the plain version; and REST in two processes (the
             serving phase's 1,000 nodes x 2,000 pods served by the card
             child, beside the earlier phases; the
             scheduler in a child process armed with
             "seed=42,rest:error:n=2,watch:error:n=2"): both points fired
             twice, every pod bound exactly once on the server, no
             recovery logged;
  measure    scheduler_perf's runner and the recorders (harness/perf.py,
             utils/trace.py, utils/slo.py, utils/telemetry.py):
             Preemption (config/performance-config.yaml:158-162: 500
             nodes, 2,000 fillers, 500 preemptors) through run_workload
             in this process with the flight recorder (an 8-cycle ring,
             so it sheds), the SLO tracker and the telemetry ring armed:
             the FlightRecorder item's cycles are the ring's and its
             cycles plus drops every committed record, every pod bound or
             evicted, every evicted pod a filler deleted once, no capacity
             overcommitted, no recovery or demotion; the backlog's world
             drained under "pallas" disarmed and then with the three
             recorders armed: the same placements and K1 launches, every
             launch held against the plain version, every auction under
             GangRounds, and /debug/flightz?format=chrome answering with
             one root span per cycle; then SustainedLoadRunner on 5,000
             hollow nodes (poisson_stream at 200 pods/s for 20 s, seed
             11, mean dwell 10 s, the departures after 20 s not fired;
             gang under "pallas", batch 256, a 2 s telemetry window,
             settle 30 s): every offered pod bound, departed or pending,
             none bound twice, completed_frac >= 0.95, no recovery or
             demotion, K1 launched and every launch held against the
             plain version (the steady verdict, offered and completed
             rates, behind_max_s and K1's launches reported); last, on
             its own, ``python -m kubetpu_torch.harness.perf --config
             config/performance-config.yaml --only
             SchedulingBasic5000Nodes`` (5,000 nodes, 5,000 init pods,
             1,000 measured; no cut) in a child process: it exits 0 with
             every measured pod bound (pods/s, SchedulerStats and the
             four latency histograms reported).  A fault that a serving
             loop (Scheduler.run under run_workload, the sustained run,
             the serving phase's run, the CLI's) logs and goes on past
             fails the phase (LoggedFaults; the CLI's stderr);
  profile    the slice and backlog (pallas) drains once more under
             torch.profiler, and the fill's first 5 of 20 cycles (5,000
             fillers: a cut, the whole drain's trace costs ~1 min):
             device busy time, the drain's device idle share, top kernels
             (separate runs, so the profiler's overhead stays out of the
             numbers above); and the seq_slice drain with
             the profiler on over a steady window of 128 scan steps: the
             same numbers for the window, the kernel launches per step and
             the gemv kernels' share of the device time; and the
             gang_spread drain with the profiler on over 16 auction rounds
             (rounds 40-55): the same numbers per round; and one decision
             audit (explain_verdicts in the first cycle of the packed
             fill with 1,000 preemptors, every row failing) under the
             profiler: its host dispatch time, stream time, kernel busy
             time and top kernels;
  guards     the JAX runtime's guard rails on the backlog's world (1,000
             nodes x 4,096 900m pods, "pallas", batch 4,096, one windowed
             cycle, a frozen queue clock): the drain disarmed, then under
             the sanitizer (the NaN and rank-promotion checks of every
             aten op, K1's output checked, the card's NaN index read at
             the readback; every auction under GangRounds' "error" mode)
             with K1's library loaded again under its compile-count
             watchdog (once, no key twice), then pipelined at depth 2
             with the binder pool under the race harness (no unguarded
             mutation, no lock-order inversion, no hold past 5,000 ms;
             every lock role's holds reported, with the holder's CPU
             time over each hold past 200 ms); the same placements each
             time.  In the card child, beside the earlier phases,
             ``python -m kubetpu_torch.kubeaot build`` writes the kernel
             artifacts;
             then a serve child (``chip_smoke.py --guards-child serve``:
             KUBETPU_AOT_DIR, an empty KUBETPU_KERNEL_CACHE_DIR, no nvcc
             on PATH or under CUDA_HOME) prewarms from the artifact and
             drains, and a corrupt child (KUBETPU_CHAOS=aot-load:corrupt:
             n=1, nvcc reachable, an empty cache) counts
             recoveries{aot-fallback} 1, rebuilds with nvcc and drains:
             the same placements, their seconds to the first cycle (the
             corrupt child is the cold nvcc one) reported side by side.
             Every K1 launch of the five drains is held bitwise to the
             plain version.  The reference phase's term-bearing
             preemption drain also counts its reprieve's CUDA graph
             captures under the compile-count watchdog;

Every drain records Events (utils/events.py) into its store: the fill's
drains hold one Scheduled Event per filler, the preempt drain one
Preempted Event per eviction, with preemption_attempts_total and the
preemption_victims count and sum equal to the drain's own tallies.

Every sequential scan (the reference check's and each seq_* drain's) runs
under torch.cuda.set_sync_debug_mode("error"): a host sync inside the
step fails the smoke.  The scans' wall time per step (enqueue, and until
the device is done) is reported, with the time of one of the step's two
dense [N, L] matvecs at the drain's own shape.  Likewise every gang
auction on the card (each gang drain's and the reference checks') runs
under "error" but for its two permitted reads, the exact-sum check
before the rounds and the one flags read per round (GangRounds), and
each auction's flag reads must equal its rounds.  Such an error, or any
other of the kernel path, raises out of the scheduler (it is never
recovered), and every drain of the smoke but the injected fault's fails
on a recovered cycle or a demotion (check_no_recovery).

The main path is the pallas drain of each of slice, backlog, fill,
preempt, gang_anti, gang_spread and autoscaler, each sequential drain,
binpack's card drains, points' card drains, the card drains of volumes,
resident's card drains, serving's fill and vol_backlog drains,
extenders' 5,000-node card drain, journal's armed fill drain and its
replay on the card (counted apart as journal_replay), chaos' backlog
drain, measure's sustained run and parity drains and the five drains of
guards (two of them in its children): the
kernel launch count is zeroed just before each and read just after it,
and reported per path.  The slice never launches the kernel (above), nor do the
term-bearing gang drains (routed to the lax round, as the JAX package
routes them) or the sequential replay (no propose step: the JAX
package's scan reaches no Pallas kernel), nor does binpack (its scores
route to lax), nor does the extender path (it scores with one
filter-and-score program and selects on the host, as the JAX package
does); in the backlog, fill, autoscaler, term-free points and
vol_backlog drains, resident's 5,000-node gang drain, chaos' backlog
drain, measure's parity drains and sustained run, the journal's
replay and the guards drains every launch's inputs and outputs are
recorded (the fill's, autoscaler's, vol_backlog's
and the preempt drain's first 16)
and, after the drain, the outputs are held bitwise against the plain
version on the same inputs, and the kernel is timed on the widest
recorded launch's real inputs.

Phases run in ALL_PHASES' order, the kernel phase first and alone.
Once it is done, main() starts two spawned children, and stops both
before it returns: the reference child (CPU_REF_THREADS torch threads)
runs the CPU halves of the card-vs-CPU drains (reference's two
preemption drains, volumes' 500-node and vol_backlog drains,
seq_slice's, binpack's and resident's 1,000-node drains, the extender
drains' CPU side), and the card child runs, one after another, the
extenders phase's two card drains (beside the reference, points and
volumes phases), then the checks that run in processes of their own:
serving's CLI and REST store, chaos' REST store and the guards phase's
kernel-artifact round trip (kubeaot build, the serve and corrupt
children); each phase collects its own results.  The smaller CPU references
(reference's auctions and replay, points' drains), and a child's job of
a phase called without main(), run in this process on CPU_REF_THREADS
torch threads (cpu_threads); the card phases keep torch's default.

The second-to-last lines print the card (nvidia-smi's name and power
limit) and the kernels' JSON line; the last line is the contract's
{"ok": true, "device": {...}}.  Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

# the kernel phase first (its times have the card to themselves); then the
# phases the card child's extender drains run beside (reference, points,
# volumes: card-vs-CPU checks); the extenders phase collects those drains
ALL_PHASES = ("kernel", "reference", "points", "volumes", "slice",
              "backlog", "fill", "preempt", "seq_slice", "seq_anti",
              "seq_spread", "gang_anti", "gang_spread", "autoscaler",
              "binpack", "resident", "mesh", "serving", "extenders",
              "journal", "chaos", "measure", "profile", "guards")
MAIN_PATHS = ("slice", "backlog", "fill", "preempt", "seq_slice",
              "seq_anti", "seq_spread", "gang_anti", "gang_spread",
              "autoscaler", "binpack", "points", "volumes", "resident",
              "mesh", "serving", "extenders", "chaos", "measure",
              "journal", "guards")
FILL_NODES = 5000             # Preemption5000Nodes: 5,000 nodes,
FILL_PODS = 4 * FILL_NODES    # 20,000 init pods (four 900m pods fill a node)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_query(fields: str) -> str:
    """nvidia-smi --query-gpu=<fields> for card 0, as it prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + fields, "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % out.stderr)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return gpu_query("name,power.limit")


# ---------------------------------------------------------------------------
# worlds


def hollow_store(n_nodes, existing_per_node, zones=8, init_labels=10,
                 varied=False):
    """n_nodes hollow nodes with existing_per_node bound pods each, or,
    with varied=True, i % (existing_per_node + 1) pods on node i."""
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.harness import hollow
    store = ClusterStore()
    for i, n in enumerate(hollow.make_nodes(n_nodes, zones=zones)):
        store.add(n)
        k = i % (existing_per_node + 1) if varied else existing_per_node
        for j in range(k):
            p = hollow.make_pod(f"init-{i}-{j}", mem=250 << 20,
                                labels={"app": f"app-{(i + j) % init_labels}",
                                        "group": "init"})
            p.spec.node_name = n.name
            store.add(p)
    return store


def counting_store(src=None):
    """A ClusterStore holding ``src``'s nodes and pods that counts bind
    calls per pod: the no-double-bind oracle."""
    from kubetpu_torch.client.store import ClusterStore

    class CountingStore(ClusterStore):
        def __init__(self):
            super().__init__()
            self.bind_calls = []

        def bind(self, pod, node_name):
            self.bind_calls.append(pod.metadata.name)
            super().bind(pod, node_name)
    store = CountingStore()
    for kind in ("Node", "Pod"):
        for obj in (src.list(kind) if src is not None else ()):
            store.add(obj)
    return store


def filler_pods(n):
    """Preemption's init pods (kubetpu/harness/perf.py's filler template,
    reference pod-low-priority.yaml): 900m, 250 Mi, priority -10."""
    from kubetpu_torch.harness import hollow
    return [hollow.make_pod(f"init-{i}", cpu_milli=900, mem=250 << 20,
                            priority=-10, labels={"group": "init"})
            for i in range(n)]


def pending_pods(n, prefix, group_labels=10, cpu_milli=100, mem=250 << 20):
    from kubetpu_torch.harness import hollow
    return [hollow.make_pod(f"{prefix}-{i}", cpu_milli=cpu_milli, mem=mem,
                            labels={"app": f"app-{i % group_labels}",
                                    "group": prefix})
            for i in range(n)]


def fresh_tensorize(sched) -> None:
    """Tensorize every cycle from scratch, the port's path before the
    resident cluster: no chain, and a DeltaTensorizer whose resync
    interval of 0 rebuilds the whole cluster on every refresh."""
    from kubetpu_torch.state.delta import DeltaTensorizer
    sched.config.chain_cycles = False
    for name, fwk in sched.profiles.items():
        sched._delta[name] = DeltaTensorizer(
            hard_pod_affinity_weight=fwk.hard_pod_affinity_weight,
            resync_interval=0, device=sched.device)


def resident_report(sched, seconds) -> dict:
    """Where a drain's clusters came from, and what tensorize and upload
    cost it."""
    src = sched.cluster_sources
    return dict(drain_s=seconds, tensorize_s=sched.stage_s["tensorize"],
                upload_s=sched.stage_s["upload"],
                chain_s=sched.stage_s["chain"], stage_s=dict(sched.stage_s),
                chain_uses=src.count("chain"),
                resyncs=sched.resync_count,
                delta_cycles=sched.delta_cycle_count,
                delta_rows=list(sched.delta_rows), sources=list(src))


def placements_of(store) -> dict:
    return {p.metadata.name: p.spec.node_name for p in store.list("Pod")}


def check_no_recovery(sched, what) -> None:
    """Fail on any cycle the scheduler recovered (its dispatch raised or
    blew the deadline) and on a latched demotion: on the main path every
    cycle runs to its commit on its own route."""
    from kubetpu_torch.utils import pallas_backend as PB
    if sched.recovery_log or PB.demotion() is not None:
        raise AssertionError("%s: recovered %s, demotion %r"
                             % (what, list(sched.recovery_log),
                                PB.demotion()))


# what the port logs at WARNING or above: the serving loop logs and goes on
# past a cycle that raised, and so the scheduler past a failed prewarm,
# preemption wave or pipeline flush, and after a cycle recovery
PORT_FAULT_LINES = ("scheduling cycle raised", "prewarm failed",
                    "preemption wave failed", "cycle recovery (",
                    "pipeline flush at close failed", "Traceback")


class LoggedFaults:
    """Collects every record of WARNING or above that the port logs (the
    "kubetpu_torch" logger and its children) while open, and raises on
    exit if there was one: a fault that a serving loop (Scheduler.run,
    run_workload, SustainedLoadRunner) logged and went on past fails the
    phase as if it had been raised."""

    def __init__(self, what):
        self.what = what
        self.records = []

    def __enter__(self):
        import logging
        records = self.records

        class Collect(logging.Handler):
            def emit(self, record):
                records.append(record)
        self._handler = Collect(logging.WARNING)
        logging.getLogger("kubetpu_torch").addHandler(self._handler)
        return self

    def __exit__(self, exc_type, *exc):
        import logging
        logging.getLogger("kubetpu_torch").removeHandler(self._handler)
        if not self.records:
            return False
        fmt = logging.Formatter("%(name)s %(levelname)s %(message)s")
        for r in self.records[:3]:
            print(fmt.format(r), file=sys.stderr)
        if exc_type is None:
            raise AssertionError("%s: the port logged %d faults; the first:"
                                 "\n%s" % (self.what, len(self.records),
                                           fmt.format(self.records[0])))
        return False


def drain(store, pods, backend, batch_size, device, record=None,
          record_limit=None, profile=None, families=None, fresh=False,
          chain=True, mesh_shape=None, max_cycles=None):
    """Drain ``pods`` through Scheduler.schedule_pending, in gang mode
    under ``backend``, or, with backend None, under the default
    configuration (the sequential replay); profile: the scheduler's one
    KubeSchedulerProfile (default: the default plugin set).  record: a
    list that receives the first ``record_limit`` (default: all) propose
    launches as (inputs, outputs), cloned, for the check against the
    plain version; families: a dict counting every launch by its layout
    ("default" or "generic" combine); fresh: tensorize every cycle from
    scratch (fresh_tensorize); chain=False: delta refreshes every cycle,
    no chain; mesh_shape: the configuration's device mesh; max_cycles:
    stop after that many cycles.  A gang drain on the card without a mesh
    runs every auction under GangRounds (one host read per round, nothing
    else); returns (scheduler, placements, seconds, GangRounds summary or
    None)."""
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.scheduler import Scheduler
    cfg = KubeSchedulerConfiguration(
        profiles=[profile or KubeSchedulerProfile()], batch_size=batch_size,
        mesh_shape=mesh_shape)
    if backend is not None:
        cfg.mode, cfg.kernel_backend = "gang", backend
    sched = Scheduler(store, config=cfg, device=device)
    if fresh:
        fresh_tensorize(sched)
    if not chain:
        sched.config.chain_cycles = False
    for p in pods:
        store.add(p)
    placed = {}
    restore = (_record_launches(record, record_limit, families)
               if record is not None else None)
    gang_card = (backend is not None and device == "cuda"
                 and mesh_shape is None)
    try:
        with GangRounds() if gang_card else contextlib.nullcontext() as gr:
            t0 = time.perf_counter()
            while sched.cycle_count != max_cycles:
                out = sched.schedule_pending()
                if not out:
                    break
                for o in out:
                    placed[o.pod.metadata.name] = o.node
            seconds = time.perf_counter() - t0
    finally:
        if restore is not None:
            restore()
    sched.close()
    check_no_recovery(sched, "drain %s %s" % (backend or "sequential",
                                              device))
    if sched.preempt_wave_failures:
        raise AssertionError("drain: %d preemption waves failed"
                             % sched.preempt_wave_failures)
    return sched, placed, seconds, gr.summary() if gang_card else None


class GangRounds:
    """Instruments the gang auction on the card: every call of
    models/gang._gang_program runs under
    torch.cuda.set_sync_debug_mode("error") except its two permitted host
    reads, the exact-sum check before the rounds and the one flags read
    that ends each round (each run with the mode off).  A hidden sync
    anywhere else in the auction raises.  Checks that each auction read
    the flags exactly once per round, and times the auctions (wall, until
    the device is done).  Restores everything on exit."""

    def __init__(self):
        self.auctions = self.rounds = self.reads = 0
        self.seconds = 0.0

    def __enter__(self):
        import torch
        from kubetpu_torch.models import gang as G
        self._orig = (G._gang_program, G._check_exact_sums, G._read_flags)
        program, check, read = self._orig

        def allowed(fn):
            def call(*args, **kw):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode(0)
                try:
                    return fn(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            return call

        def read_flags(flags):
            self.reads += 1
            return allowed(read)(flags)

        def gang_program(cluster, batch, *args, **kw):
            if batch.req.device.type != "cuda":
                return program(cluster, batch, *args, **kw)
            reads0 = self.reads
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = program(cluster, batch, *args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            rounds = int(out.rounds)
            if not self.reads - reads0 == out.syncs == rounds:
                raise AssertionError(
                    "gang auction: %d flag reads, %d syncs, %d rounds"
                    % (self.reads - reads0, out.syncs, rounds))
            self.auctions += 1
            self.rounds += rounds
            return out

        G._gang_program = gang_program
        G._check_exact_sums = allowed(check)
        G._read_flags = read_flags
        return self

    def __exit__(self, *exc):
        from kubetpu_torch.models import gang as G
        G._gang_program, G._check_exact_sums, G._read_flags = self._orig

    def summary(self) -> dict:
        return dict(auctions=self.auctions, rounds=self.rounds,
                    flag_reads=self.reads, sync_debug="error",
                    auction_s=self.seconds,
                    ms_per_round=(self.seconds / self.rounds * 1e3
                                  if self.rounds else None))


def _record_launches(record, limit, families=None):
    """Wrap the CUDA wrapper so each launch's inputs and outputs are
    cloned into ``record`` (clones are enqueued on the launch's stream),
    and each launch's combine counted in ``families``; returns the
    function that restores it."""
    import torch
    from kubetpu_torch.ops import propose as PK
    orig = PK.propose_cuda

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    def recording(bundle, rows, live, req, nz, ports_used):
        if families is not None:
            key = ("default" if bundle["layout"].default_family
                   else "generic")
            families[key] = families.get(key, 0) + 1
        if limit is not None and len(record) >= limit:
            return orig(bundle, rows, live, req, nz, ports_used)
        ins = ({k: clone(v) for k, v in bundle.items()}, clone(rows),
               clone(live), clone(req), clone(nz), clone(ports_used))
        out = orig(bundle, rows, live, req, nz, ports_used)
        record.append((ins, tuple(clone(x) for x in out)))
        return out

    PK.propose_cuda = recording

    def restore():
        PK.propose_cuda = orig
    return restore


def check_recorded(record, what) -> dict:
    """The main path's own launches against the plain version, bitwise."""
    import torch
    from kubetpu_torch.ops import propose as PK
    max_err = 0.0
    for i, (ins, (kp, ka, kb)) in enumerate(record):
        pp, pa, pb = PK.propose_plain(*ins)
        if not (torch.equal(kp, pp) and torch.equal(ka, pa)
                and torch.equal(kb, pb)):
            raise AssertionError("%s: launch %d of the drain differs from "
                                 "the plain version (%d rows)"
                                 % (what, i, int((kp != pp).sum())))
        max_err = max(max_err, float((kb - pb).abs().max()))
    shapes = sorted({(ins[1].shape[0], ins[0]["planes"].shape[2],
                      ins[0]["planes"].shape[1], ins[0]["breq"].shape[1],
                      ins[0]["bports"].shape[1], ins[0]["n_zones"])
                     for ins, _ in record})
    # the kernel timed on one recorded launch's real inputs (the one with
    # the most live rows)
    ins = max((ins for ins, _ in record),
              key=lambda x: int(x[2].sum()) * x[0]["planes"].shape[2])[0:6]
    real_ms = kernel_ms(ins)[0]
    real_bound, _ = bound_of(*ins)
    return dict(checked=len(record), max_abs_err=max_err,
                shapes_WNBRPZ=[list(x) for x in shapes],
                real_launch=dict(W=ins[1].shape[0],
                                 N=ins[0]["planes"].shape[2],
                                 live_rows=int(ins[2].sum()), ms=real_ms,
                                 bound_ms=real_bound,
                                 share_of_bound=real_bound / real_ms))


def node_infos_of(store) -> list:
    """The store's NodeInfos, each with its bound pods."""
    from kubetpu_torch.framework.types import NodeInfo
    infos = {}
    for n in store.list("Node"):
        ni = NodeInfo()
        ni.set_node(n)
        infos[n.name] = ni
    for p in store.list("Pod"):
        if p.spec.node_name:
            infos[p.spec.node_name].add_pod(p)
    return list(infos.values())


def tensorize(store, pods):
    """Host (numpy) build of one cycle's cluster and batch."""
    from kubetpu_torch.framework.types import PodInfo
    from kubetpu_torch.models.batch import PodBatchBuilder
    from kubetpu_torch.state.tensors import SnapshotBuilder
    node_infos = node_infos_of(store)
    pinfos = [PodInfo(p) for p in pods]
    builder = SnapshotBuilder()
    builder.intern_pending(pinfos)
    host = builder.build(node_infos)
    batch = PodBatchBuilder(builder.table).build(pinfos)
    return host, batch


class SeqScans:
    """Instruments the sequential replay on the card: each scan (the
    loop over the pod rows, models/sequential._scan) runs under
    torch.cuda.set_sync_debug_mode("error") and is timed (host enqueue,
    and until the device is done); the scheduler's calls record the
    cluster's [N, L] label shape.  Restores everything on exit."""

    def __init__(self):
        self.scans = self.steps = 0
        self.enqueue_s = self.done_s = 0.0
        self.kv_shape = None

    def __enter__(self):
        import torch
        import kubetpu_torch.scheduler as SCH
        from kubetpu_torch.models import sequential as S
        self._orig = (S._scan, SCH.schedule_sequential)
        orig_scan, orig_entry = self._orig

        def scan(step, B):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = orig_scan(step, B)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            self.scans += 1
            self.steps += B
            self.enqueue_s += t1 - t0
            self.done_s += time.perf_counter() - t0
            return out

        def entry(cluster, batch, *args, **kw):
            self.kv_shape = tuple(cluster.kv.shape)
            return orig_entry(cluster, batch, *args, **kw)

        S._scan, SCH.schedule_sequential = scan, entry
        return self

    def __exit__(self, *exc):
        import kubetpu_torch.scheduler as SCH
        from kubetpu_torch.models import sequential as S
        S._scan, SCH.schedule_sequential = self._orig

    def summary(self) -> dict:
        return dict(scans=self.scans, steps=self.steps,
                    enqueue_ms_per_step=self.enqueue_s / self.steps * 1e3,
                    ms_per_step=self.done_s / self.steps * 1e3,
                    sync_debug="error")


def kv_matvec_ms(shape) -> float:
    """One of the step's two dense matvecs (torch.mv of the [N, L] label
    one-hot, as f32, with an [L] vector) at ``shape``, on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    kv = (torch.rand(shape, device="cuda", generator=g) < 0.001).float()
    v = torch.rand(shape[1], device="cuda", generator=g)
    torch.mv(kv, v)
    return time_ms(lambda: torch.mv(kv, v), 50)


def anti_world(n_nodes=5000, n_pods=1000):
    """SchedulingPodAntiAffinity5000Nodes (kubetpu/harness/perf.py:146-148
    builds its pods): 1,000 init pods bound one per node on every fifth
    node, 1,000 pending; every pod has app-{i % 1000} and required
    hostname anti-affinity to its own app.  (Smaller sizes only for a
    CPU rehearsal.)"""
    from kubetpu_torch.api import types as api
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.harness import hollow
    store = ClusterStore()
    nodes = hollow.make_nodes(n_nodes, zones=8)
    for n in nodes:
        store.add(n)

    def pod(prefix, i):
        app = f"app-{i % n_pods}"
        p = hollow.make_pod(f"{prefix}-{i}", mem=250 << 20,
                            labels={"app": app, "group": prefix})
        return hollow.with_anti_affinity(p, api.LABEL_HOSTNAME,
                                         match={"app": app})
    for i in range(n_pods):
        p = pod("init", i)
        p.spec.node_name = nodes[5 * i].name
        store.add(p)
    return store, [pod("measured", i) for i in range(n_pods)]


def spread_world(n_nodes=5000, n_pods=2000):
    """TopologySpreading5000Nodes (perf.py:169-172): 5,000 nodes in 8
    zones, 5,000 init pods bound one per node, 2,000 pending; every pod
    has a DoNotSchedule zone constraint, max_skew 2, over its group.
    (Smaller sizes only for a CPU rehearsal.)"""
    from kubetpu_torch.api import types as api
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.harness import hollow
    store = ClusterStore()
    nodes = hollow.make_nodes(n_nodes, zones=8)
    for n in nodes:
        store.add(n)

    def pod(prefix, i):
        p = hollow.make_pod(f"{prefix}-{i}", mem=250 << 20,
                            labels={"app": f"app-{i % 10}", "group": prefix})
        return hollow.with_spread(p, api.LABEL_ZONE, max_skew=2,
                                  when="DoNotSchedule",
                                  match={"group": prefix})
    for i in range(n_nodes):
        p = pod("init", i)
        p.spec.node_name = nodes[i].name
        store.add(p)
    return store, [pod("measured", i) for i in range(n_pods)]


def _seq_drain(what, store, pods, n_expected, profile=None):
    """One sequential drain on the card under SeqScans, K1's launches
    counted; every pod placed and no capacity violated."""
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.scheduler import capacity_violations
    PK.propose.launches = 0          # this path starts: zero the count
    with SeqScans() as scans:
        sched, placed, seconds, _ = drain(store, pods, None, 1000, "cuda",
                                          profile=profile)
    launches = PK.propose.launches
    n_placed = sum(1 for v in placed.values() if v)
    if n_placed != n_expected:
        raise AssertionError("%s: %d/%d pods placed"
                             % (what, n_placed, n_expected))
    bad = capacity_violations(store)
    if bad:
        raise AssertionError("%s: capacity violated on %s" % (what, bad[:5]))
    kv_ms = kv_matvec_ms(scans.kv_shape)
    scan = scans.summary()
    return sched, placed, dict(
        placed=n_placed, cycles=sched.cycle_count, launches=launches,
        drain_s=seconds, stage_s=sched.stage_s,
        resident=resident_report(sched, seconds),
        pods_per_s=n_placed / seconds,
        next_start=sched._next_start_node_index, scan=scan,
        kv_shape_NL=list(scans.kv_shape), kv_matvec_ms=kv_ms,
        kv_matvecs_share_of_step=2 * kv_ms / scan["ms_per_step"])


# ---------------------------------------------------------------------------
# phases


def _same_gang_result(cpu, card, what) -> None:
    """Every GangResult field equal card vs CPU (floats finite)."""
    import torch
    for f in cpu._fields:
        a, c = getattr(cpu, f), getattr(card, f)
        if f == "syncs":
            ok = a == c
        else:
            ok = torch.equal(a, c.cpu())
            if a.dtype.is_floating_point:
                ok = ok and bool(torch.isfinite(c).all())
        if not ok:
            raise AssertionError("reference: %s differs card vs CPU (%s)"
                                 % (f, what))


def _gang_card_vs_cpu(run, what) -> tuple:
    """run(device) on the CPU and on the card (under GangRounds): the
    results, equal on every field, and the card run's sync check."""
    with cpu_threads():
        cpu = run("cpu")
    with GangRounds() as rounds:
        card = run("cuda")
    _same_gang_result(cpu, card, what)
    return cpu, rounds.summary()


def phase_reference() -> dict:
    """Small auctions card vs CPU, identical GangResult (shared gumbel):
    a term-free world under both backends, at full width and windowed,
    and with a host score bias on the pallas route (K1's bias plane); a
    world with every default family live under intra-batch topology;
    and the sequential replay."""
    import torch
    from kubetpu_torch.models.batch import batch_to_device
    from kubetpu_torch.models.gang import schedule_gang
    from kubetpu_torch.models.programs import ProgramConfig
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.utils import prng
    store = hollow_store(48, 2)
    pods = pending_pods(200, "ref", cpu_milli=900)
    host, hbatch = tensorize(store, pods)
    rng = prng.PRNGKey(7)
    B = hbatch.valid.shape[0]
    N = host.arrays["allocatable"].shape[0]
    gumbel = prng.select_plane(rng, B, N)
    bias = torch.rand((B, N), generator=torch.Generator().manual_seed(5)) * 9
    out = {}
    for backend, window, with_bias in (("lax", 0, False), ("lax", 64, False),
                                       ("pallas", 0, False),
                                       ("pallas", 64, False),
                                       ("pallas", 0, True)):
        def run(dev):
            return schedule_gang(
                host.to_device(dev), batch_to_device(hbatch, dev),
                ProgramConfig(), rng.to(dev), intra_batch_topology=False,
                residual_window=window, kernel_backend=backend,
                score_bias=bias.to(dev) if with_bias else None,
                gumbel=gumbel.to(dev))
        name = "%s_w%d%s" % (backend, window, "_bias" if with_bias else "")
        launches = PK.propose.launches
        res, _ = _gang_card_vs_cpu(run, name)
        out[name + "_rounds"] = int(res.rounds)
        out[name + "_placed"] = int((res.chosen >= 0).sum())
        if with_bias:
            out[name + "_k1_launches"] = PK.propose.launches - launches
            if out[name + "_k1_launches"] <= 0:
                raise AssertionError("reference: the bias world did not "
                                     "launch K1")
    out["gang_topology"] = _gang_topology_reference()
    out["sequential"] = _seq_reference()
    out.update(_preemption_references())
    return out


def _gang_topology_reference() -> dict:
    """The gang auction with intra-batch topology, card vs CPU, identical
    GangResult (shared plane), on the world with every default family
    live (seq_worlds seed 31, 1,000 nodes x 512 pods), with a random
    host_ok and score_bias, at full width and with a 64-row window."""
    import torch
    from kubetpu_torch.harness import seq_worlds as SW
    from kubetpu_torch.models.batch import batch_to_device
    from kubetpu_torch.models.gang import schedule_gang
    from kubetpu_torch.models.programs import ProgramConfig
    from kubetpu_torch.utils import prng
    host, hbatch, host_key = SW.port_inputs(31, 1000, 512)
    cfg = ProgramConfig(hostname_topokey=host_key,
                        active_topo_keys=SW.term_keys(hbatch))
    rng = prng.PRNGKey(17)
    B = hbatch.valid.shape[0]
    N = host.arrays["allocatable"].shape[0]
    gumbel = prng.select_plane(rng, B, N)
    g = torch.Generator().manual_seed(19)
    host_ok = torch.rand((B, N), generator=g) < 0.9
    bias = torch.rand((B, N), generator=g) * 7
    out = dict(B=B, N=N, active_topo_keys=list(cfg.active_topo_keys))
    for window in (0, 64):
        def run(dev):
            t0 = time.perf_counter()
            res = schedule_gang(host.to_device(dev),
                                batch_to_device(hbatch, dev), cfg,
                                rng.to(dev), host_ok=host_ok.to(dev),
                                intra_batch_topology=True,
                                residual_window=window,
                                score_bias=bias.to(dev),
                                gumbel=gumbel.to(dev))
            out["w%d_%s_s" % (window, dev)] = time.perf_counter() - t0
            return res
        res, rounds = _gang_card_vs_cpu(run, "intra w%d" % window)
        placed = int((res.chosen >= 0).sum())
        if placed < 256 or int(res.rounds) < 2:
            raise AssertionError("reference: the topology world placed %d "
                                 "pods in %d rounds" % (placed,
                                                        int(res.rounds)))
        out["w%d" % window] = dict(rounds=int(res.rounds), placed=placed,
                                   unresolvable=int(res.unresolvable.sum()),
                                   sync_check=rounds)
    out["matches_cpu"] = True
    return out


def _seq_reference() -> dict:
    """The sequential replay, card vs CPU, identical SeqResult (shared
    plane), on a world with every default family live."""
    import torch
    from kubetpu_torch.harness import seq_worlds as SW
    from kubetpu_torch.models import sequential as S
    from kubetpu_torch.models.batch import batch_to_device
    from kubetpu_torch.models.programs import ProgramConfig
    from kubetpu_torch.utils import prng
    host, hbatch, host_key = SW.port_inputs(31, 1000, 512)
    cfg = ProgramConfig(hostname_topokey=host_key,
                        percentage_of_nodes_to_score=0)
    rng = prng.PRNGKey(13)
    B = hbatch.valid.shape[0]
    N = host.arrays["allocatable"].shape[0]
    gumbel = prng.select_plane(rng, B, N)

    def run(dev):
        return S.schedule_sequential(host.to_device(dev),
                                     batch_to_device(hbatch, dev), cfg,
                                     rng.to(dev), start_index=37,
                                     gumbel=gumbel.to(dev))
    t0 = time.perf_counter()
    with cpu_threads():
        cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    with SeqScans() as scans:
        t0 = time.perf_counter()
        card = run("cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    for f in cpu._fields:
        a, c = getattr(cpu, f), getattr(card, f)
        ok = torch.equal(a, c.cpu())
        if a.dtype.is_floating_point:
            ok = ok and bool(torch.isfinite(c).all())
        if not ok:
            raise AssertionError("reference: sequential %s differs card vs "
                                 "CPU" % f)
    placed = int((cpu.chosen >= 0).sum())
    n_feas = cpu.n_feasible[cpu.chosen >= 0]
    if placed < 256 or int(n_feas.max()) >= int(host.arrays[
            "node_valid"].sum()):
        raise AssertionError("reference: the sequential world did not "
                             "place most pods under binding sampling")
    return dict(B=B, N=N, placed=placed, n_feasible_max=int(n_feas.max()),
                next_start=int(cpu.next_start), cpu_s=cpu_s, card_s=card_s,
                scan=scans.summary(), matches_cpu=True)


def random_bundle(seed, W, N, device, with_bias=False, Z=8, B=None,
                  scores=None, sentinels=0, extreme=False):
    """The propose arguments (bundle, rows, live, req, nz, ports_used) of
    a seeded world at real widths (kubetpu_torch/harness/propose_worlds,
    the builder the port's tests use): a B-row bundle (B = W by default)
    with 16 port ids, and W window rows of it, ascending as the gang loop
    takes them, ``sentinels`` of them past B; extreme: division operands
    outside the kernel's fast division range."""
    from kubetpu_torch.harness import propose_worlds as PW
    B = B or W
    w = PW.world(seed, B, N, with_bias, Z, scores, P=16, extreme=extreme)
    rows = (None if W == B and not sentinels
            else PW.window_rows(seed, B, W, sentinels))
    return PW.propose_args(w, rows, device)


def _sectors(flags, first):
    """32-byte sectors of f32 rows holding at least one element where
    flags [W, N] is True; row w's element 0 lies ``first[w]`` floats
    past a 32-byte boundary."""
    import torch
    W, N = flags.shape
    sec = (first[:, None] + torch.arange(N, device=flags.device)) // 8
    occ = torch.zeros((W, N // 8 + 2), dtype=torch.int32,
                      device=flags.device)
    occ.scatter_add_(1, sec, flags.int())
    return int((occ > 0).sum())


def bound_of(bundle, rows, live, req, nz, ports_used):
    """Least time on the card for one propose step, from this call's
    inputs and what its data needs.  Bytes: each live window row's mask
    row and row-vector entries; its plane values only at the nodes where
    it is feasible (the gumbel plane only where the row's best score
    ties, the DefaultPodTopologySpread plane not at all on a spread-skip
    row), counted in the 32-byte sectors that hold them; the node tables
    and the round's carries once, at the nodes some live row's mask
    admits; rows, live and the three outputs; all over HBM bandwidth.
    Operations: 2 per resource channel and port id at each admitted
    (row, node), ~40 f32 ops of the default family's combine at each
    feasible one, over the f32 rate.  Sentinel and non-live rows read
    no bundle row."""
    import torch
    from kubetpu_torch.ops import propose as PK
    L = bundle["layout"]
    S, B, N = bundle["planes"].shape
    R, P = bundle["breq"].shape[1], bundle["bports"].shape[1]
    W = rows.shape[0]
    sub = PK._rows_of(bundle, rows)
    f = PK._feasible(sub, L, live, req, ports_used)
    total = PK._combine(sub, L, f, nz)
    best = torch.where(f, total, torch.full_like(total, PK.NEG)).amax(1)
    need = {"gumbel": f & (total == best[:, None]),
            "dps_raw": f & ~sub["skip"][:, None]}
    rsafe = rows.long().clamp(0, B - 1)
    p0 = bundle["planes"].data_ptr() // 4
    plane_bytes = 0
    for i, name in enumerate(L.planes):
        first = (p0 + (i * B + rsafe) * N) % 8
        plane_bytes += 32 * _sectors(need.get(name, f), first)
    w_live = int(live.sum())
    admitted = sub["mask"] & live[:, None]
    n_admitted = int(admitted.any(0).sum())
    nbytes = plane_bytes + w_live * (N + R * 4 + 2 * 4 + P * 4 + 1 + 1)
    nbytes += n_admitted * (R * 4 + 4 + R * 4 + 2 * 4 + P * 4)
    nbytes += W * (8 + 1) + W * (4 + 4 + 1)     # rows, live; outputs
    ops = (int(admitted.sum()) * (2 * R + 2 * P)
           + int(f.sum()) * 40)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps, rounds=5):
    """Device milliseconds per call: CUDA events around ``reps``
    back-to-back calls (so the host's enqueue overlaps the device work),
    median over ``rounds`` such windows."""
    import torch
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def kernel_ms(args, reps=20):
    """The kernel alone (a staged launch, no wrapper checks), warm."""
    from kubetpu_torch.ops import propose as PK
    launch, _ = PK.bind_propose(*args)
    for _ in range(3):
        launch()
    return time_ms(launch, reps), launch


def phase_kernel() -> dict:
    import torch
    from kubetpu_torch.harness.propose_worlds import GENERIC_SCORES
    from kubetpu_torch.models.programs import ProgramConfig
    from kubetpu_torch.ops import propose as PK
    # (seed, W, N, bias plane, zones, B, scores, sentinels, extreme): the
    # slice's shapes under the default-family specialisation; a W=512
    # window of a 1,024-row bundle with sentinel rows; the generic layout
    # walk (Most/LeastAllocated, weights 2 and 3, bias); 16 zones
    # (shared-memory zone sums); N above the shared-memory staging
    # threshold (statistics planes read from device memory in both
    # passes), under both layouts; ragged N (row starts off 16 bytes: bulk
    # copies over the aligned interior, scalar ends); division operands
    # outside the fast division's range (recomputed with __fdiv_rn), under
    # both layouts
    worlds = [(11, 1024, 8192, False, 8, 1024, None, 0, False),
              (12, 1024, 8192, True, 8, 1024, None, 0, False),
              (13, 512, 8192, False, 8, 1024, None, 24, False),
              (14, 512, 8192, True, 8, 1024, GENERIC_SCORES, 24, False),
              (15, 1024, 8192, True, 16, 1024, None, 0, False),
              (16, 256, 20480, False, 16, 256, None, 8, False),
              (17, 256, 20480, True, 8, 256, GENERIC_SCORES, 0, False),
              (18, 512, 8189, False, 8, 700, None, 8, False),
              (19, 300, 4999, True, 8, 300, GENERIC_SCORES, 0, False),
              (20, 512, 8192, True, 8, 1024, None, 24, True),
              (24, 512, 8192, False, 8, 512, GENERIC_SCORES, 0, True)]
    staged_max = PK.staged_max_n(PK.layout_for(ProgramConfig(), False),
                                 5, 16, 8)
    max_err = 0.0
    for seed, W, N, bias, Z, B, scores, sent, extreme in worlds:
        args = random_bundle(seed, W, N, "cuda", with_bias=bias, Z=Z, B=B,
                             scores=scores, sentinels=sent, extreme=extreme)
        if args[0]["layout"].default_family != (scores is None):
            raise AssertionError("world %d: wrong instantiation" % seed)
        kp, ka, kb = PK.propose_cuda(*args)
        pp, pa, pb = PK.propose_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(kp, pp) and torch.equal(ka, pa)
                and torch.equal(kb, pb)):
            bad = int((kp != pp).sum())
            raise AssertionError("propose kernel != plain (seed %d, W %d, "
                                 "N %d, bias %s, Z %d): %d rows differ"
                                 % (seed, W, N, bias, Z, bad))
        max_err = max(max_err, float((kb - pb).abs().max()))
        if not bool((~pa).any()) or not bool(pa.any()):
            raise AssertionError("world %d lacks active or inactive rows"
                                 % seed)
    # the kernel's branch-free division against __fdiv_rn, bit for bit
    fast_div_pairs = 1 << 28
    bad = PK.check_fast_div(fast_div_pairs, seed=7)
    if bad:
        raise AssertionError("fast division differs from __fdiv_rn on %d "
                             "of %d pairs" % (bad, fast_div_pairs))
    if not 8192 < staged_max < 20480:
        raise AssertionError("staging threshold %d: the worlds above do "
                             "not take both branches" % staged_max)
    # time at the slice's full width (default family, no bias plane): the
    # kernel alone (staged launch), the whole wrapper (checks, launch),
    # and the plain version; then a W=512 window of a 1,024-row bundle
    # (the windowed path's shape)
    args = random_bundle(21, 1024, 8192, "cuda")
    ms, launch = kernel_ms(args)
    # the generic combine at the same W x N, the ClusterAutoscaler
    # profile's scores (the descriptor walk, not the compiled-in default
    # family), timed between two timings of the default family
    args_g = random_bundle(21, 1024, 8192, "cuda",
                           scores=profile_scores(autoscaler_profile()))
    if args_g[0]["layout"].default_family:
        raise AssertionError("autoscaler layout took the default family")
    ms_generic = kernel_ms(args_g)[0]
    ms_default_again = kernel_ms(args)[0]
    bound_generic, _ = bound_of(*args_g)
    wrapper_ms = time_ms(lambda: PK.propose_cuda(*args), 20)
    plain_ms = time_ms(lambda: PK.propose_plain(*args), 3)
    bound_ms, bound_by = bound_of(*args)
    args_w = random_bundle(22, 512, 8192, "cuda", B=1024)
    ms_w = kernel_ms(args_w)[0]
    bound_w, _ = bound_of(*args_w)
    plain_w = time_ms(lambda: PK.propose_plain(*args_w), 3)
    # the term-free main path's DefaultPodTopologySpread raw is all zero
    # (no controller selectors): time that input too
    b0 = dict(args[0])
    dps = PK.plane_order(ProgramConfig(), False).index("dps_raw")
    b0["planes"] = args[0]["planes"].clone()
    b0["planes"][dps] = 0.0
    ms_dps0 = kernel_ms((b0,) + tuple(args[1:]))[0]
    # above the staging threshold (N=20,480, statistics planes read twice)
    ms_big = kernel_ms(random_bundle(23, 256, 20480, "cuda"))[0]
    # the selectHost gumbel plane at the slice's widths: XLA's f32 log
    # (float64 fused multiply-adds), and the torch-log plane it replaced
    import numpy as np
    from kubetpu_torch.utils import prng
    rng = prng.PRNGKey(3, device="cuda")
    tiny = float(np.finfo(np.float32).tiny)

    def torch_log_plane():
        keys = prng.fold_in(rng, torch.arange(1024, device="cuda"))
        u = prng.uniform(keys, (8192,), tiny, 1.0)
        return -torch.log(-torch.log(u))
    plane_ms = time_ms(lambda: prng.select_plane(rng, 1024, 8192), 5)
    plane_torch_log_ms = time_ms(torch_log_plane, 5)
    # the SM clock and power while the kernel runs: queue ~0.5 s of
    # launches, read nvidia-smi meanwhile, then drain
    for _ in range(max(200, int(500 / ms))):
        launch()
    clocks = gpu_query("clocks.sm,clocks.max.sm,power.draw")
    torch.cuda.synchronize()
    return dict(max_abs_err=max_err, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms,
                ms_generic=ms_generic, bound_ms_generic=bound_generic,
                ms_default_again=ms_default_again,
                ms_w512=ms_w, bound_ms_w512=bound_w, plain_ms_w512=plain_w,
                share_of_bound_w512=bound_w / ms_w,
                ms_dps_zero=ms_dps0, ms_n20480_unstaged=ms_big,
                staged_max_n=staged_max, worlds=len(worlds),
                gumbel_plane_ms_1024x8192=plane_ms,
                gumbel_plane_torch_log_ms=plane_torch_log_ms,
                fast_div_pairs_checked=fast_div_pairs,
                under_load=clocks)


def _gang_drain(what, store, pods, n_expected, batch_size=1000,
                profile=None):
    """One gang drain on the card under "pallas" (the serving
    configuration), K1's launches counted, every auction under
    GangRounds; every pod placed and no capacity violated."""
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.scheduler import capacity_violations
    PK.propose.launches = 0          # this path starts: zero the count
    sched, placed, seconds, rounds = drain(store, pods, "pallas",
                                           batch_size, "cuda",
                                           profile=profile)
    launches = PK.propose.launches
    n_placed = sum(1 for v in placed.values() if v)
    if n_placed != n_expected:
        raise AssertionError("%s: %d/%d pods placed"
                             % (what, n_placed, n_expected))
    bad = capacity_violations(store)
    if bad:
        raise AssertionError("%s: capacity violated on %s" % (what, bad[:5]))
    return sched, dict(placed=n_placed, cycles=sched.cycle_count,
                       rounds=sched.gang_rounds, syncs=sched.gang_syncs,
                       routes=sched.gang_backends, launches=launches,
                       drain_s=seconds, stage_s=sched.stage_s,
                       pods_per_s=n_placed / seconds, sync_check=rounds)


def phase_slice() -> dict:
    """SchedulingBasic5000Nodes through Scheduler.schedule_pending.  On
    identical nodes every round-0 proposal fits, so the cycle ends after
    the plain round 0 and the kernel (rounds >= 1) never runs."""
    return _gang_drain("slice", hollow_store(5000, 1),
                       pending_pods(1000, "measured"), 1000)[1]


def _intra_routes(what, out):
    """Every cycle of a term-bearing drain ran the lax round, routed for
    the reason the reference gives, and K1 never launched."""
    if set(out["routes"]) != {("lax", "intra-batch-topology")}:
        raise AssertionError("%s: routes %s" % (what, out["routes"]))
    if out["launches"] != 0:
        raise AssertionError("%s: K1 launched %d times"
                             % (what, out["launches"]))


def phase_gang_anti() -> dict:
    """SchedulingPodAntiAffinity5000Nodes in gang mode (the seq_anti
    world and cut), batch 1,000: intra-batch topology."""
    store, pods = anti_world()
    _, out = _gang_drain("gang_anti", store, pods, 1000)
    _intra_routes("gang_anti", out)
    out["apps_checked"] = check_anti(store, "gang_anti")
    return out


def phase_gang_spread() -> dict:
    """TopologySpreading5000Nodes in gang mode (the seq_spread world and
    cut), batch 1,000: two cycles, each windowed (B = 1,024 > 512)."""
    store, pods = spread_world()
    _, out = _gang_drain("gang_spread", store, pods, 2000)
    _intra_routes("gang_spread", out)
    out["measured_per_zone"] = check_spread(store, "gang_spread")
    out["rounds_per_cycle"] = out["rounds"]
    out["ms_per_round"] = out["sync_check"]["ms_per_round"]
    return out


# The card-vs-CPU phases hold a card drain against the same drain on the
# CPU, which at 5,000 nodes takes tens of seconds to minutes of CPU time.
# main() runs those CPU drains in one spawned child (the reference child,
# CPU_REF_THREADS torch threads) beside the card phases, and the extender
# path's card drains and the checks that run in processes of their own in
# a second child on the card (card_jobs); each phase
# collects its own jobs from CHILD_JOBS.  A phase run without main() runs
# them in process.
CPU_REF_THREADS = 4
CHILD_JOBS = {}


@contextlib.contextmanager
def cpu_threads():
    """This process's torch threads at CPU_REF_THREADS while a CPU
    reference runs here, beside the reference child's; restored after."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(CPU_REF_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _ref_child_init() -> None:
    import torch
    torch.set_num_threads(CPU_REF_THREADS)


def child_result(job, fn, *args):
    """``job``'s result from main()'s children, or fn(*args) run here
    (CPU references on CPU_REF_THREADS threads); and the seconds this
    process waited for it."""
    fut = CHILD_JOBS.get(job)
    CHILD_JOBS[job] = None           # collected
    t0 = time.perf_counter()
    if fut is not None:
        out = fut.result()
    else:
        with cpu_threads():
            out = fn(*args)
    return out, time.perf_counter() - t0


def _seq_cpu_reference(what) -> dict:
    """The replay of seq_slice's or binpack's world (5,000 nodes, one
    bound pod each, the 1,000 measured pods) on the CPU: placements,
    final start index, seconds and stages."""
    profile = binpack_profile() if what == "binpack" else None
    sched, placed, seconds, _ = drain(
        hollow_store(5000, 1), pending_pods(1000, "measured"), None, 1000,
        "cpu", profile=profile)
    return dict(placed=placed, next_start=sched._next_start_node_index,
                seconds=seconds, stage_s=dict(sched.stage_s))


def _seq_card_vs_cpu(what, card_placed, card_sched) -> dict:
    """The timed card drain of ``what`` against the CPU replay of the
    same world: the same placements of all 1,000 pods and the same final
    start index."""
    cpu, waited = child_result(what, _seq_cpu_reference, what)
    if cpu["placed"] != card_placed:
        diff = [k for k in card_placed
                if card_placed[k] != cpu["placed"].get(k)]
        raise AssertionError("%s: %d placements differ card vs CPU"
                             % (what, len(diff)))
    if cpu["next_start"] != card_sched._next_start_node_index:
        raise AssertionError("%s: start index differs card vs CPU" % what)
    return dict(cpu_pods=len(card_placed), cpu_drain_s=cpu["seconds"],
                cpu_stage_s=cpu["stage_s"], cpu_wait_s=waited,
                matches_cpu=True)


def phase_seq_slice() -> dict:
    """SchedulingBasic5000Nodes under the default configuration, on the
    card and on the CPU: same placements, same final start index."""
    sched, placed, out = _seq_drain("seq_slice", hollow_store(5000, 1),
                                    pending_pods(1000, "measured"), 1000)
    out.update(_seq_card_vs_cpu("seq_slice", placed, sched))
    return out


def check_anti(store, what) -> int:
    """No two pods of one app on a node; returns the apps checked."""
    nodes_of = {}
    for p in store.list("Pod"):
        nodes_of.setdefault(p.metadata.labels["app"], []).append(
            p.spec.node_name)
    shared = [a for a, ns in nodes_of.items() if len(set(ns)) != len(ns)]
    if shared:
        raise AssertionError("%s: pods of one app share a node (%s)"
                             % (what, shared[:5]))
    return len(nodes_of)


def check_spread(store, what) -> list:
    """The measured group's pods per zone, skew at most 2."""
    from kubetpu_torch.api import types as api
    zone_of = {n.name: n.metadata.labels[api.LABEL_ZONE]
               for n in store.list("Node")}
    counts = {}
    for p in store.list("Pod"):
        if p.metadata.labels.get("group") == "measured":
            z = zone_of[p.spec.node_name]
            counts[z] = counts.get(z, 0) + 1
    per_zone = [counts.get(z, 0) for z in sorted(set(zone_of.values()))]
    if max(per_zone) - min(per_zone) > 2:
        raise AssertionError("%s: zone skew %s" % (what, per_zone))
    return per_zone


def phase_seq_anti() -> dict:
    store, pods = anti_world()
    _, _, out = _seq_drain("seq_anti", store, pods, 1000)
    out["apps_checked"] = check_anti(store, "seq_anti")
    return out


def phase_seq_spread() -> dict:
    store, pods = spread_world()
    _, _, out = _seq_drain("seq_spread", store, pods, 2000)
    out["measured_per_zone"] = check_spread(store, "seq_spread")
    return out


def _pallas_vs_lax(what, make_world, batch_size, record_limit=None,
                   profile=None):
    """Drain one world under "pallas" (counting and recording the
    kernel's launches, and counting them by combine) and a fresh copy
    under "lax"; the placements must be identical.  Returns per-backend
    numbers and the store of each."""
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.scheduler import capacity_violations
    out, placements, stores = {}, {}, {}
    for backend in ("pallas", "lax"):
        store, pods = make_world()
        record = [] if backend == "pallas" else None
        families = {}
        PK.propose.launches = 0      # this path starts: zero the count
        sched, placed, seconds, rounds = drain(store, pods, backend,
                                               batch_size, "cuda", record,
                                               record_limit, profile,
                                               families)
        launches = PK.propose.launches
        if capacity_violations(store):
            raise AssertionError("%s: capacity violated (%s)"
                                 % (what, backend))
        placements[backend], stores[backend] = placed, store
        n_placed = sum(1 for v in placed.values() if v)
        out[backend] = dict(placed=n_placed, cycles=sched.cycle_count,
                            rounds=sched.gang_rounds, syncs=sched.gang_syncs,
                            launches=launches, drain_s=seconds,
                            stage_s=sched.stage_s,
                            pods_per_s=n_placed / seconds,
                            sync_check=rounds, launches_by_combine=families,
                            resident=resident_report(sched, seconds))
        if record is not None:
            if launches <= 0:
                raise AssertionError("%s: the propose kernel never launched"
                                     % what)
            out[backend]["recorded"] = check_recorded(record, what)
    if placements["pallas"] != placements["lax"]:
        diff = [k for k in placements["lax"]
                if placements["lax"][k] != placements["pallas"].get(k)]
        raise AssertionError("%s: pallas and lax placements differ for %d "
                             "pods" % (what, len(diff)))
    out["placements_match"] = True
    return out, stores


def backlog_world():
    return (hollow_store(1000, 3, varied=True),
            pending_pods(4096, "backlog", cpu_milli=900))


def fill_world():
    return hollow_store(FILL_NODES, 0), filler_pods(FILL_PODS)


def phase_backlog() -> dict:
    return _pallas_vs_lax("backlog", backlog_world, 4096)[0]


FILL_LAX: dict = {}
# the fill's disarmed pallas drain, which the journal phase's armed drain
# must equal
FILL_PALLAS: dict = {}


def phase_fill() -> dict:
    """Preemption5000Nodes' init phase: every filler placed, four on every
    node (the template packs the cluster exactly); nothing is nominated,
    so no cycle runs a nominated-pods overlay pass."""
    from kubetpu_torch.models import programs as PR
    from kubetpu_torch.ops import propose as PK
    with DeviceTimed(PR, "nominated_fit_mask") as overlay:
        out, stores = _pallas_vs_lax("fill", fill_world, 1000,
                                     record_limit=16)
    # the mesh phase holds its (2, 2) fill against this lax drain, the
    # journal phase its armed drain against the pallas one
    FILL_LAX.update(placements=placements_of(stores["lax"]),
                    rounds=list(out["lax"]["rounds"]))
    FILL_PALLAS.update(placements=placements_of(stores["pallas"]))
    if overlay.events:
        raise AssertionError("fill: %d nominated-pods overlay passes with "
                             "nothing nominated" % len(overlay.events))
    out["overlay_passes"] = 0
    # the third drain: a full build every cycle (chaining off, resync
    # interval 0), the path before the resident cluster; the same
    # placements
    store, pods = fill_world()
    record = []
    PK.propose.launches = 0
    sched, placed, seconds, _ = drain(store, pods, "pallas", 1000, "cuda",
                                      record, 16, fresh=True)
    if placements_of(store) != placements_of(stores["pallas"]):
        raise AssertionError("fill: the fresh-per-cycle drain's placements "
                             "differ from the chained drain's")
    if sched.resync_count != len(sched.cluster_sources):
        raise AssertionError("fill: the fresh drain did not rebuild every "
                             "cycle (%s)" % sched.cluster_sources)
    out["fresh"] = dict(placed=sum(1 for v in placed.values() if v),
                        cycles=sched.cycle_count,
                        launches=PK.propose.launches,
                        recorded=check_recorded(record, "fill fresh"),
                        placements_match_chained=True,
                        resident=resident_report(sched, seconds))
    # the fourth: delta refreshes every cycle and no chain, what the
    # chain is measured against; the same placements
    store, pods = fill_world()
    record = []
    PK.propose.launches = 0
    sched, placed, seconds, _ = drain(store, pods, "pallas", 1000, "cuda",
                                      record, 16, chain=False)
    if placements_of(store) != placements_of(stores["pallas"]):
        raise AssertionError("fill: the delta-only drain's placements "
                             "differ from the chained drain's")
    if "chain" in sched.cluster_sources:
        raise AssertionError("fill: the delta-only drain chained")
    out["delta_only"] = dict(placed=sum(1 for v in placed.values() if v),
                             cycles=sched.cycle_count,
                             launches=PK.propose.launches,
                             recorded=check_recorded(record,
                                                     "fill delta-only"),
                             placements_match_chained=True,
                             resident=resident_report(sched, seconds))
    for backend, store in stores.items():
        if out[backend]["placed"] != FILL_PODS:
            raise AssertionError("fill: %d/%d pods placed (%s)"
                                 % (out[backend]["placed"], FILL_PODS,
                                    backend))
        per_node = {}
        for p in store.list("Pod"):
            per_node[p.spec.node_name] = per_node.get(p.spec.node_name,
                                                      0) + 1
        if len(per_node) != FILL_NODES or set(per_node.values()) != {4}:
            raise AssertionError("fill: nodes not packed four each (%s)"
                                 % backend)
        out[backend]["scheduled_events"] = check_scheduled_events(
            store, [p.metadata.name for p in store.list("Pod")],
            "fill %s" % backend)
    return out


def packed_fill_store(n_nodes=FILL_NODES):
    """The fill's end state: 4 * n_nodes fillers bound four per node (the
    fill phase drains exactly this packing)."""
    store = hollow_store(n_nodes, 0)
    for i, p in enumerate(filler_pods(4 * n_nodes)):
        p.spec.node_name = f"node-{i // 4}"
        store.add(p)
    return store


def preemptor_pods(n):
    """Preemption's measured pods (kubetpu/harness/perf.py:111-116): 600m,
    250 Mi, priority 100 — more cpu than a packed node has free."""
    from kubetpu_torch.harness import hollow
    return [hollow.make_pod(f"measured-{i}", cpu_milli=600, mem=250 << 20,
                            priority=100,
                            labels={"app": f"app-{i % 10}",
                                    "group": "measured"})
            for i in range(n)]


class DeviceTimed:
    """CUDA-event stream time of every call of ``module.name`` whose first
    argument (the cluster) lies on the card: from the call's first enqueue
    to its last, so host launch gaps inside a many-kernel call count (the
    profile phase splits one audit call into busy and idle).  Calls on the
    CPU pass through.  Events only: no sync inside the call.  Restored on
    exit."""

    def __init__(self, module, name):
        self.module, self.name, self.events = module, name, []

    def __enter__(self):
        import torch
        self._orig = fn = getattr(self.module, self.name)

        def call(cluster, *args, **kw):
            if not cluster.requested.is_cuda:
                return fn(cluster, *args, **kw)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(cluster, *args, **kw)
            b.record()
            self.events.append((a, b))
            return out
        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._orig)

    def ms(self) -> list:
        import torch
        if not self.events:
            return []
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def _preempt_drain(store, pods, backend, device, batch_size=None,
                   parked=(), record=None, record_limit=None, fresh=False,
                   max_cycles=None, extenders=(), metrics=None,
                   on_sched=None):
    """Drain ``pods`` through the failure path: gang under ``backend``, or
    the default configuration with backend None.  Backoff is 0 and, when
    nothing is active but pods wait, the unschedulable pods move at once
    (the reference's 60 s leftover flush, compressed).  ``parked``: (pod,
    node) nominations made before the drain.  On the card every auction
    runs under GangRounds, every scan under SeqScans.  fresh: tensorize
    every cycle from scratch (fresh_tensorize).  max_cycles: stop after
    that many scheduling cycles.  extenders: the configuration's
    extenders; metrics: a SchedulerMetrics to feed; on_sched: called
    with the scheduler before the drain.  Returns (scheduler,
    placements, deleted pods [(name, priority, group)] in order,
    nominations, seconds, sync summary)."""
    import torch
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.scheduler import Scheduler
    cfg = KubeSchedulerConfiguration(profiles=[KubeSchedulerProfile()],
                                     extenders=list(extenders))
    if batch_size:
        cfg.batch_size = batch_size
    if backend is not None:
        cfg.mode, cfg.kernel_backend = "gang", backend
    sched = Scheduler(store, config=cfg, device=device, metrics=metrics)
    if fresh:
        fresh_tensorize(sched)
    if on_sched is not None:
        on_sched(sched)
    # no backoff: set on the queue, since a configuration must ask for
    # more than 0 s
    sched.queue._initial_backoff = sched.queue._max_backoff = 0.0
    deleted = []
    orig_delete = store.delete

    def delete(obj):
        if obj.kind == "Pod":
            deleted.append((obj.metadata.name, obj.priority(),
                            obj.metadata.labels.get("group")))
        return orig_delete(obj)
    store.delete = delete
    for p, nn in parked:
        sched.queue.add_nominated_pod(p, nn)
    for p in pods:
        store.add(p)
    placed = {}
    restore = (_record_launches(record, record_limit)
               if record is not None else None)
    card = device == "cuda"
    # with an extender no auction or scan runs: each pod is scored by one
    # filter-and-score program
    watched = card and not extenders
    guard = (GangRounds() if watched and backend is not None
             else SeqScans() if watched else contextlib.nullcontext())
    try:
        with guard as gr:
            t0 = time.perf_counter()
            idle = cycles = 0
            while len(sched.queue) and cycles != max_cycles:
                sched.queue.flush_backoff_completed()
                out = sched.schedule_pending()
                cycles += 1
                if out:
                    idle = 0
                    for o in out:
                        placed[o.pod.metadata.name] = o.node
                    continue
                idle += 1
                if idle > 2:
                    raise AssertionError("preemption drain stalled with %d "
                                         "pods queued" % len(sched.queue))
                sched.queue.move_all_to_active_or_backoff_queue(
                    "UnschedulableTimeout")
            if card:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        if restore is not None:
            restore()
        store.delete = orig_delete
    sched.close()
    check_no_recovery(sched, "preempt drain %s %s" % (backend, device))
    noms = {p.metadata.name: p.status.nominated_node_name
            for p in store.list("Pod") if p.status.nominated_node_name}
    return (sched, placed, deleted, noms, seconds,
            gr.summary() if watched else None)


def _preempt_stats(sched) -> dict:
    """The drain's preemption counters (Scheduler.preempt_stats)."""
    tot = {k: sum(c[k] for c in sched.preempt_stats)
           for k in ("waves", "rounds", "evictions", "reads")}
    tot["wave_rounds"] = tot.pop("rounds")
    tot["reads_per_wave"] = (tot["reads"] / tot["waves"] if tot["waves"]
                             else None)
    return tot


def phase_preempt(n_nodes=FILL_NODES, device="cuda") -> dict:
    """Preemption5000Nodes' measured phase on the packed fill: 5,000
    preemptors through the PostFilter wave, gang under "pallas", batch
    1,000.  (Smaller sizes and the CPU only for a rehearsal.)"""
    from kubetpu_torch import preemption as PRE
    from kubetpu_torch.models import programs as PR
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.scheduler import Scheduler, capacity_violations
    from kubetpu_torch.utils.decisions import DecisionLog
    from kubetpu_torch.utils.metrics import SchedulerMetrics
    store = packed_fill_store(n_nodes)
    pods = preemptor_pods(n_nodes)
    record = []
    decisions = []
    audit_rows = []          # (failed rows, valid rows) per audit call
    orig_record = DecisionLog.record
    orig_audit = Scheduler._audit_failures

    def spy(log, d):
        decisions.append(d)
        return orig_record(log, d)

    def audit_spy(sched, cycle_ctx, failed, host_ok):
        audit_rows.append((len(failed), len(cycle_ctx.row_of)))
        return orig_audit(sched, cycle_ctx, failed, host_ok)
    DecisionLog.record = spy
    Scheduler._audit_failures = audit_spy
    metrics = SchedulerMetrics()
    tallies = []
    PK.propose.launches = 0          # this path starts: zero the count
    try:
        with DeviceTimed(PR, "whatif_wave") as wave_t, \
                DeviceTimed(PRE, "_whatif_reprieve") as rep_t, \
                DeviceTimed(PR, "explain_verdicts") as audit_t:
            sched, placed, deleted, noms, seconds, rounds = _preempt_drain(
                store, pods, "pallas", device, n_nodes // 5, record=record,
                record_limit=16, metrics=metrics,
                on_sched=lambda s: tallies.append(PreemptTally(s)))
    finally:
        DecisionLog.record = orig_record
        Scheduler._audit_failures = orig_audit
    launches = PK.propose.launches
    # the decision audit of the first cycle: every failed preemptor is
    # attributed to NodeResourcesFit
    first = [d for d in decisions
             if d.cycle == 1 and d.outcome == "unschedulable"]
    if not first or any("NodeResourcesFit" not in d.rejections
                        for d in first):
        raise AssertionError("preempt: %d first-cycle failures, not all "
                             "attributed to NodeResourcesFit" % len(first))
    audit_ms = audit_t.ms()
    unbound = [p.metadata.name for p in store.list("Pod")
               if p.metadata.labels.get("group") == "measured"
               and not p.spec.node_name]
    if unbound or len(placed) != n_nodes:
        raise AssertionError("preempt: %d preemptors unbound (%s)"
                             % (len(unbound), unbound[:5]))
    names = [d[0] for d in deleted]
    if len(set(names)) != len(names):
        raise AssertionError("preempt: a pod was deleted twice")
    bad = [d for d in deleted if d[2] != "init" or d[1] >= 100]
    if bad:
        raise AssertionError("preempt: evicted non-fillers or peers: %s"
                             % bad[:5])
    if capacity_violations(store):
        raise AssertionError("preempt: capacity violated")
    if sched.preempt_wave_failures:
        raise AssertionError("preempt: %d waves failed"
                             % sched.preempt_wave_failures)
    stats = _preempt_stats(sched)
    wave_ms = wave_t.ms()
    if stats["evictions"] != len(deleted):
        raise AssertionError("preempt: %d evictions counted, %d pods "
                             "deleted" % (stats["evictions"], len(deleted)))
    # the metrics and Events against the drain's own tallies
    observed = check_preemption_observed("preempt", metrics, tallies[0],
                                         store, deleted)
    out = dict(placed=len(placed), cycles=sched.cycle_count,
               observed=observed, events=event_counts(store),
               **stats, launches=launches,
               routes=sorted(set(sched.gang_backends)),
               auction_rounds=sched.gang_rounds, drain_s=seconds,
               stage_s=sched.stage_s, pods_per_s=len(placed) / seconds,
               whatif_calls=len(wave_ms), whatif_ms=wave_ms,
               whatif_ms_per_wave=(sum(wave_ms) / stats["waves"]
                                   if stats["waves"] else None),
               reprieve_calls=len(rep_t.ms()), sync_check=rounds,
               resident=resident_report(sched, seconds),
               first_cycle_failures_audited=len(first),
               audit_calls=len(audit_ms), audit_stream_ms=audit_ms,
               audit_failed_rows=[f for f, _ in audit_rows],
               audit_valid_rows=[v for _, v in audit_rows],
               failure_cycles=sum(1 for c in sched.preempt_stats
                                  if c["waves"]))
    if record:
        out["recorded"] = check_recorded(record, "preempt")
    # the same drain tensorized from scratch every cycle: the same
    # evictions and placements
    fstore = packed_fill_store(n_nodes)
    fsched, fplaced, fdeleted, _, fseconds, _ = _preempt_drain(
        fstore, preemptor_pods(n_nodes), "pallas", device, n_nodes // 5,
        fresh=True)
    if fdeleted != deleted or placements_of(fstore) != placements_of(store):
        raise AssertionError("preempt: the fresh-per-cycle drain differs "
                             "from the delta/chained one")
    out["fresh"] = dict(matches_delta=True, cycles=fsched.cycle_count,
                        resident=resident_report(fsched, fseconds))
    return out


def _preempt_world(what):
    """The reference phase's preemption worlds, (store, pods, parked):
    scheduler_perf's Preemption (500 nodes, 2,000 fillers, 500
    preemptors) or the term-bearing preempt_worlds world (seed 21)."""
    if what == "Preemption":
        return packed_fill_store(500), preemptor_pods(500), ()
    from kubetpu_torch.api import types as api
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.harness import preempt_worlds as PW
    w = PW.world(api, 21, 48, 16, terms=True)
    store = ClusterStore()
    PW.populate(store, w)
    return store, w.pending, w.parked


def _preempt_world_drain(what, backend, device, batch_size=None) -> dict:
    """``what``'s world (_preempt_world) drained on ``device``: deleted
    pods in order, nominations, placements, decisions, seconds, and on
    the card the stats and sync check."""
    from kubetpu_torch import preemption as PRE
    from kubetpu_torch.utils import sanitize
    store, pods, parked = _preempt_world(what)
    # the compile-count watchdog alone: each reprieve call captures its
    # CUDA graph again at the same shapes, a recapture by its count
    wd = sanitize.install_compile_watchdog()
    try:
        with DeviceTimed(PRE, "_whatif_reprieve") as rep_t:
            sched, placed, deleted, noms, seconds, sync = _preempt_drain(
                store, pods, backend, device, batch_size, parked)
    finally:
        sanitize.uninstall_compile_watchdog(wd)
    captures = {k: c for k, c in wd.counts.items()
                if k[0] == "capture:whatif_reprieve"}
    if sched.preempt_wave_failures:
        raise AssertionError("reference %s: a wave failed" % what)
    out = dict(run=(placed, deleted, noms), log=decision_view(sched),
               seconds=seconds)
    if device == "cuda":
        rep_ms = rep_t.ms()
        out["card"] = dict(placed=sum(1 for v in placed.values() if v),
                           pods=len(pods), cycles=sched.cycle_count,
                           deleted=len(deleted), **_preempt_stats(sched),
                           card_s=seconds, sync_check=sync,
                           reprieve_calls=len(rep_ms),
                           reprieve_ms_per_call=(sum(rep_ms) / len(rep_ms)
                                                 if rep_ms else None),
                           reprieve_graph_captures=sum(captures.values()),
                           reprieve_graph_recaptures=sum(
                               c - 1 for c in captures.values()),
                           reprieve_graph_shapes=len(captures))
    return out


def _preempt_card_vs_cpu(what, backend, batch_size=None):
    """``what``'s world drained on the card and on the CPU (main()'s
    reference child): the same deleted pods in the same order, the same
    nominations, the same placements and decisions."""
    card = _preempt_world_drain(what, backend, "cuda", batch_size)
    cpu, waited = child_result("reference " + what, _preempt_world_drain,
                               what, backend, "cpu", batch_size)
    if cpu["run"] != card["run"]:
        raise AssertionError("reference %s: card and CPU differ (deleted "
                             "%s, nominations %s, placements %s)" % (
                                 what, cpu["run"][1] == card["run"][1],
                                 cpu["run"][2] == card["run"][2],
                                 cpu["run"][0] == card["run"][0]))
    if not cpu["run"][1] or not cpu["run"][2]:
        raise AssertionError("reference %s: nothing was preempted" % what)
    if cpu["log"] != card["log"]:
        diff = [k for k in cpu["log"] if cpu["log"][k] != card["log"].get(k)]
        raise AssertionError("reference %s: DecisionLogs differ card vs CPU "
                             "(%d pods, e.g. %s)" % (what, len(diff),
                                                    diff[:3]))
    return dict(card["card"], cpu_s=cpu["seconds"], cpu_wait_s=waited,
                matches_cpu=True, decisions_match_cpu=len(cpu["log"]))


def decision_view(sched) -> dict:
    """Every pod's last decision: outcome, node, rejections, blocking,
    best node and score, nomination, message."""
    return {d.name: (d.outcome, d.node, d.rejections, d.blocking,
                     d.best_node, d.best_score, d.nominated_node, d.message,
                     d.n_feasible)
            for d in sched.decisions.recent(10 ** 6)}


def _preemption_references() -> dict:
    """scheduler_perf's Preemption (500 nodes, 2,000 fillers, 500
    preemptors) in the default configuration, and a term-bearing
    preempt_worlds world in gang mode (the per-pod reprieve)."""
    out = dict(preemption_seq=_preempt_card_vs_cpu("Preemption", None))
    terms = _preempt_card_vs_cpu("terms", "pallas", 8)
    if not terms["reprieve_calls"]:
        raise AssertionError("reference terms: no per-pod reprieve ran")
    out["preemption_terms"] = terms
    return out


# ---------------------------------------------------------------------------
# the resident cluster: delta refreshes and chains under churn


def resident_world(n_nodes, batch, waves, seed=8):
    """A seeded churn world: n_nodes hollow nodes (4 cpu) each holding
    three 900m fillers of priority -10 (one free slot), some also a 100m
    pod; ``waves`` x
    ``batch`` pending 900m pods of priority 0, and batch // 2 preemptors
    of 2,000m at priority 100, which fit nowhere until a filler is
    evicted.  Returns (store, pods, churn): churn(cycle, store) applies
    the cluster events before a cycle — external binds, pod deletions,
    node label updates, one new taint (inside the taint vocabulary's
    cap), one node added — the same on every device."""
    import copy
    import random
    from kubetpu_torch.api import types as api
    from kubetpu_torch.harness import hollow
    from kubetpu_torch.utils.intern import pow2_bucket
    def bound(p, node):
        # uids from names: two runs in one process give equal uid lists
        p.metadata.uid = "u-" + p.metadata.name
        p.spec.node_name = node
        store.add(p)

    store = hollow_store(n_nodes, 0)
    for i, p in enumerate(filler_pods(3 * n_nodes)):
        bound(p, f"node-{i // 3}")
    # small bound pods that put the pod count 1.5 batches under its pow2
    # bucket: the chain's bucket guard then lets the first cycles chain
    for j in range(pow2_bucket(3 * n_nodes) - 3 * n_nodes - 3 * batch // 2):
        bound(hollow.make_pod(f"small{j}", cpu_milli=100,
                              labels={"group": "small"}), f"node-{j}")
    pods = [hollow.make_pod(f"w{i}", cpu_milli=900, mem=250 << 20,
                            labels={"app": f"app-{i % 10}",
                                    "group": "measured"})
            for i in range(waves * batch)]
    pods += [hollow.make_pod(f"pre{i}", cpu_milli=2000, mem=250 << 20,
                             priority=100, labels={"group": "preemptor"})
             for i in range(batch // 2)]
    for p in pods:
        p.metadata.uid = "u-" + p.metadata.name
    r = random.Random(seed)
    k = max(n_nodes // 100, 2)

    def churn(cycle, store):
        # events before cycles 1, 3, 5, 6 and 7; cycles 2 and 4 see none
        # and can chain (gang mode)
        if cycle == 1:                      # external binds
            for j in range(k):
                bound(hollow.make_pod(f"ext{j}", cpu_milli=100,
                                      labels={"group": "external"}),
                      f"node-{r.randrange(n_nodes)}")
        elif cycle == 3:                    # deletions
            names = sorted(p.metadata.name for p in store.list("Pod")
                           if p.spec.node_name
                           and p.metadata.labels.get("group") == "init")
            for name in r.sample(names, k):
                store.delete(store.get("Pod", "default/" + name))
        elif cycle == 5:                    # node label updates
            for j in r.sample(range(n_nodes), k):
                n = copy.deepcopy(store.get("Node", f"node-{j}"))
                n.metadata.labels[api.LABEL_ZONE] = "zone-7"
                store.update(n)
        elif cycle == 6:                    # a new taint, inside the cap
            n = copy.deepcopy(store.get("Node",
                                        f"node-{r.randrange(n_nodes)}"))
            n.spec.taints.append(api.Taint(key="maintenance", value="soon",
                                           effect="PreferNoSchedule"))
            store.update(n)
        elif cycle == 7:                    # the node set changes
            store.add(hollow.make_node(f"node-{n_nodes}", zone="zone-0",
                                       region="region-0"))
    return store, pods, churn


class RefreshProbe:
    """Wraps DeltaTensorizer.refresh: after every refresh, verify() (the
    card's fingerprint against the host mirror's) must hold; with
    ``digest`` each refresh also records its outcome, pod_uid_list and a
    sha256 of every resident tensor's bytes (for card against CPU).
    Restored on exit."""

    def __init__(self, digest=False):
        self.digest = digest
        self.verified = 0
        self.records = []

    def __enter__(self):
        import hashlib
        from kubetpu_torch.state import delta as D
        self._orig = orig = D.DeltaTensorizer.refresh
        probe = self

        def refresh(dt, *a, **kw):
            cluster, st = orig(dt, *a, **kw)
            if not dt.verify():
                raise AssertionError("resident: the card's residents differ "
                                     "from the host mirror after a refresh "
                                     "(%s)" % (st.reason or "delta"))
            probe.verified += 1
            if probe.digest:
                h = hashlib.sha256()
                for f in type(cluster)._fields:
                    for leaf in D._leaves(getattr(cluster, f)):
                        x = leaf.cpu().numpy()
                        h.update(("%s%s" % (x.dtype, x.shape)).encode())
                        h.update(x.tobytes())
                probe.records.append((st.reason, st.delta_rows,
                                      dt.pod_uid_list(), h.hexdigest()))
            return cluster, st
        D.DeltaTensorizer.refresh = refresh
        return self

    def __exit__(self, *exc):
        from kubetpu_torch.state import delta as D
        D.DeltaTensorizer.refresh = self._orig


def resident_drain(n_nodes, batch, waves, backend, device, digest=False,
                   record=None, mesh_shape=None):
    """resident_world drained (gang under ``backend``, or sequential with
    None) with the churn before each cycle, the preemption drain's queue
    settings (backoff 0, unschedulable pods retried when the queue idles)
    and every refresh verified.  record: a list that receives every
    propose launch as (inputs, outputs), cloned, for check_recorded.
    mesh_shape: the configuration's device mesh (no GangRounds then).
    Returns (placements, deleted, report, refresh records)."""
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.scheduler import Scheduler, capacity_violations
    import torch
    store, pods, churn = resident_world(n_nodes, batch, waves)
    cfg = KubeSchedulerConfiguration(profiles=[KubeSchedulerProfile()],
                                     batch_size=batch, mesh_shape=mesh_shape)
    if backend is not None:
        cfg.mode, cfg.kernel_backend = "gang", backend
    sched = Scheduler(store, config=cfg, device=device)
    sched.queue._initial_backoff = sched.queue._max_backoff = 0.0
    deleted = []
    orig_delete = store.delete

    def delete(obj):
        if obj.kind == "Pod":
            deleted.append(obj.metadata.name)
        return orig_delete(obj)
    store.delete = delete
    for p in pods:
        store.add(p)
    card = device == "cuda"
    guard = (contextlib.nullcontext() if not card or mesh_shape
             else GangRounds() if backend is not None else SeqScans())
    if card:
        PK.propose.launches = 0      # this path starts: zero the count
    restore = (_record_launches(record, None)
               if record is not None else None)
    try:
        with RefreshProbe(digest) as probe, guard:
            t0 = time.perf_counter()
            cycle = idle = 0
            while len(sched.queue) and cycle < 40:
                churn(cycle, store)
                sched.queue.flush_backoff_completed()
                out = sched.schedule_pending()
                cycle += 1
                if out:
                    idle = 0
                    continue
                idle += 1
                if idle > 2:
                    raise AssertionError("resident drain stalled with %d "
                                         "pods queued" % len(sched.queue))
                sched.queue.move_all_to_active_or_backoff_queue(
                    "UnschedulableTimeout")
            if card:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        if restore is not None:
            restore()
    store.delete = orig_delete
    sched.close()
    what = "resident %s %s" % (backend or "sequential", device)
    check_no_recovery(sched, what)
    if sched.preempt_wave_failures:
        raise AssertionError("%s: a wave failed" % what)
    if capacity_violations(store):
        raise AssertionError("%s: capacity violated" % what)
    unbound = [p.metadata.name for p in store.list("Pod")
               if not p.spec.node_name]
    if unbound:
        raise AssertionError("%s: %d pods unbound" % (what, len(unbound)))
    sources = sched.cluster_sources
    for want in ("initial", "node-set", "delta"):
        if want not in sources:
            raise AssertionError("%s: no %r cycle (%s)" % (what, want,
                                                           sources))
    report = dict(cycles=sched.cycle_count, evicted=len(deleted),
                  verified=probe.verified, **resident_report(sched, seconds))
    if card:
        report["launches"] = PK.propose.launches
    return placements_of(store), deleted, report, probe.records


def phase_resident() -> dict:
    """The resident cluster under churn: a 5,000-node world drained gang
    under "pallas" (chained cycles and delta refreshes, K1's launches
    counted) and sequentially (delta refreshes), every refresh verified
    on the card; the same sequence at 1,000 nodes on the card and on the
    CPU, in both modes: the same placements and evictions, the same
    refresh outcomes, pod_uid_lists and resident bytes."""
    out = {}
    record = []
    _, _, gang, _ = resident_drain(5000, 500, 8, "pallas", "cuda",
                                   record=record)
    if "chain" not in gang["sources"]:
        raise AssertionError("resident: the gang drain never chained")
    if len(record) != gang["launches"]:
        raise AssertionError("resident: %d launches recorded of %d"
                             % (len(record), gang["launches"]))
    # every launch of the gang drain, chained cycles included, against
    # the plain version
    out["recorded"] = check_recorded(record, "resident gang")
    del record
    out["gang_5000"] = gang
    out["launches"] = gang["launches"]
    _, _, seq, _ = resident_drain(5000, 100, 7, None, "cuda")
    out["sequential_5000"] = seq
    out["launches"] += seq["launches"]
    for backend in ("pallas", None):
        what = "resident 1000 %s" % (backend or "sequential")
        cp, cd, crep, crec = resident_drain(1000, 100, 8, backend, "cuda",
                                            digest=True)
        (pp, pd, prep, prec), waited = child_result(
            what, resident_drain, 1000, 100, 8, backend, "cpu", True)
        if (cp, cd) != (pp, pd):
            raise AssertionError("%s: card and CPU differ (placements %s, "
                                 "evictions %s)" % (what, cp == pp,
                                                    cd == pd))
        if crep["sources"] != prep["sources"]:
            raise AssertionError("%s: refresh outcomes differ: %s vs %s"
                                 % (what, crep["sources"], prep["sources"]))
        for i, (a, b) in enumerate(zip(crec, prec)):
            if a != b:
                raise AssertionError(
                    "%s: refresh %d differs card vs CPU (reason %s, rows "
                    "%s, uid list %s, residents %s)" % (
                        what, i, a[0] == b[0], a[1] == b[1], a[2] == b[2],
                        a[3] == b[3]))
        if len(crec) != len(prec) or not crec:
            raise AssertionError("%s: %d vs %d refreshes" % (
                what, len(crec), len(prec)))
        out["card_vs_cpu_1000_" + (backend or "sequential")] = dict(
            card=crep, cpu_drain_s=prep["drain_s"], cpu_wait_s=waited,
            refreshes=len(crec), matches_cpu=True)
    return out



# ---------------------------------------------------------------------------
# the device mesh


class PackedProbe:
    """Records every cycle's packed readback (Scheduler._readback_group's
    host array, copied) in ``packed``.  Restored on exit."""

    def __enter__(self):
        from kubetpu_torch.scheduler import Scheduler
        self._orig = orig = Scheduler._readback_group
        self.packed = []
        probe = self

        def readback(sched, prep, res):
            out = orig(sched, prep, res)
            probe.packed.append(out.copy())
            return out
        Scheduler._readback_group = readback
        return self

    def __exit__(self, *exc):
        from kubetpu_torch.scheduler import Scheduler
        Scheduler._readback_group = self._orig


class ScatterProbe:
    """Records the first ``limit`` resident delta scatters
    (models/programs.apply_cluster_delta) as (the cluster before it,
    cloned; the delta), for check_sharded_scatter.  Restored on exit."""

    def __init__(self, limit=8):
        self.limit = limit
        self.records = []

    def __enter__(self):
        from kubetpu_torch.models import programs
        from kubetpu_torch.parallel import mesh as pmesh
        self._orig = orig = programs.apply_cluster_delta
        probe = self

        def apply(cluster, delta, donate=True):
            if len(probe.records) < probe.limit:
                probe.records.append(
                    (pmesh._tree_map(lambda t: t.clone(), cluster), delta))
            return orig(cluster, delta, donate=donate)
        programs.apply_cluster_delta = apply
        return self

    def __exit__(self, *exc):
        from kubetpu_torch.models import programs
        programs.apply_cluster_delta = self._orig


def check_sharded_scatter(records, shape) -> int:
    """Each recorded delta scattered shard by shard over a ``shape`` mesh
    on the card (parallel/mesh.sharded_apply_cluster_delta) and gathered,
    bitwise against the single-device scatter of the same delta into the
    same cluster.  Returns the number of deltas checked."""
    import numpy as np
    from kubetpu_torch.models import programs
    from kubetpu_torch.parallel import mesh as pmesh
    from kubetpu_torch.state import delta as D
    mesh = pmesh.make_mesh(shape, "cuda")
    for k, (cluster, delta) in enumerate(records):
        want = programs.apply_cluster_delta(cluster, delta, donate=False)
        got = pmesh.gather(pmesh.sharded_apply_cluster_delta(
            cluster, delta, mesh, donate=False))
        for f in type(want)._fields:
            for a, b in zip(D._leaves(getattr(want, f)),
                            D._leaves(getattr(got, f))):
                a, b = a.cpu().numpy(), b.cpu().numpy()
                if (a.dtype != b.dtype or a.shape != b.shape
                        or not np.array_equal(a.view(np.uint8),
                                              b.view(np.uint8))):
                    raise AssertionError(
                        "mesh scatter %d: %s differs from the "
                        "single-device scatter" % (k, f))
    return len(records)


def mesh_drive(make_world, backend, batch_size, mesh_shape, device="cuda",
               max_cycles=None, chain=True):
    """One drain of a fresh ``make_world()`` through the scheduler with
    ``mesh_shape`` (None: one device), every packed readback recorded.
    Returns (placements, packed readbacks, report)."""
    import numpy as np
    import torch
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.parallel import shardmap as SM
    from kubetpu_torch.scheduler import capacity_violations
    from kubetpu_torch.utils.device import shard_copy
    store, pods = make_world()
    for k in SM.tiled_stats:
        SM.tiled_stats[k] = 0
    copies0, cross0 = shard_copy.copies, shard_copy.cross_device
    PK.propose.launches = 0          # this path starts: zero the count
    with PackedProbe() as probe:
        sched, placed, seconds, _ = drain(store, pods, backend, batch_size,
                                          device, chain=chain,
                                          mesh_shape=mesh_shape,
                                          max_cycles=max_cycles)
    if device == "cuda":
        torch.cuda.synchronize()
    what = "mesh %s %s" % (mesh_shape, device)
    if capacity_violations(store):
        raise AssertionError("%s: capacity violated" % what)
    for a in probe.packed:
        if not np.isfinite(a).all():
            raise AssertionError("%s: a packed readback is not finite" % what)
    st = dict(SM.tiled_stats)
    rounds = sum(sched.gang_rounds)
    mesh = sched._mesh
    report = dict(
        shape=list(mesh_shape) if mesh_shape else None,
        placed=sum(1 for v in placed.values() if v), cycles=sched.cycle_count,
        rounds=list(sched.gang_rounds), drain_s=seconds,
        auction_s=sched.stage_s["auction"], routes=sched.gang_backends,
        sources=list(sched.cluster_sources), launches=PK.propose.launches,
        tiled=st, copies=shard_copy.copies - copies0,
        cross_device_copies=shard_copy.cross_device - cross0,
        round_copies_per_round=(st["round_copies"] / st["rounds"]
                                if st["rounds"] else None),
        ms_per_round=(sched.stage_s["auction"] / rounds * 1e3
                      if rounds else None),
        devices=(sorted({str(d) for row in mesh.devices for d in row})
                 if mesh is not None else None),
        shards_share_one_card=(not mesh.spread if mesh is not None
                               else None))
    return placements_of(store), probe.packed, report


def _same_drive(want, got, what) -> None:
    """Placements and every cycle's packed readback (chosen, n_feasible,
    all_unresolvable, rounds or the next start index) bitwise equal."""
    import numpy as np
    if want[0] != got[0]:
        diff = [k for k in want[0] if want[0][k] != got[0].get(k)]
        raise AssertionError("%s: placements differ for %d pods"
                             % (what, len(diff)))
    if len(want[1]) != len(got[1]) or not all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(want[1], got[1])):
        raise AssertionError("%s: the packed readbacks differ" % what)
    if want[2]["rounds"] != got[2]["rounds"]:
        raise AssertionError("%s: rounds %s vs %s" % (
            what, want[2]["rounds"], got[2]["rounds"]))


def _mesh_small_world():
    return (hollow_store(64, 2, varied=True),
            pending_pods(256, "small", cpu_milli=900))


def _seq_first():
    return hollow_store(5000, 1), pending_pods(256, "measured")


def phase_mesh() -> dict:
    """The device mesh on one card (every shard on cuda:0 unless the
    machine has more cards), each mesh drive bitwise against the
    single-device drive on the card: placements and every cycle's packed
    readback.  The backlog (1,000 nodes x 4,096 pods, one windowed
    cycle) at (1, 1), (1, 4) and (2, 2) on the tiled surface; the fill at
    full width at (2, 2), chained, against phase_fill's lax drain;
    gang_anti's first cycle at (2, 2), the replicated topology surface;
    seq_slice's first 256 pods at (2, 2), the replicated scan; the
    1,000-node resident drive at (2, 2) with its churn (every refresh
    verified, the residents' digests equal), whose first delta scatters
    are repeated shard by shard (the pre-sharded delta scatter) against
    the single-device scatter; and a small seeded world at (2, 2), card
    against CPU.  K1 never runs
    under a mesh (its route there is lax, as in the JAX package)."""
    out, drives = {}, []
    base = mesh_drive(backlog_world, "lax", 4096, None)
    out["backlog_single"] = base[2]
    for shape in ((1, 1), (1, 4), (2, 2)):
        got = mesh_drive(backlog_world, "lax", 4096, shape)
        _same_drive(base, got, "mesh backlog %s" % (shape,))
        drives.append(got[2])
        if got[2]["tiled"]["auctions"] != got[2]["cycles"]:
            raise AssertionError("mesh backlog %s: %s of %d cycles tiled"
                                 % (shape, got[2]["tiled"], got[2]["cycles"]))
        out["backlog_%dx%d" % shape] = got[2]
    # the fill at (2, 2), chained, against phase_fill's lax drain (run
    # here when that phase did not run)
    if not FILL_LAX:
        lax = mesh_drive(fill_world, "lax", 1000, None)
        FILL_LAX.update(placements=lax[0], rounds=lax[2]["rounds"])
    fill = mesh_drive(fill_world, "lax", 1000, (2, 2))
    drives.append(fill[2])
    if fill[0] != FILL_LAX["placements"]:
        raise AssertionError("mesh fill: placements differ from the lax "
                             "drain's")
    if fill[2]["rounds"] != FILL_LAX["rounds"]:
        raise AssertionError("mesh fill: rounds %s vs %s" % (
            fill[2]["rounds"], FILL_LAX["rounds"]))
    if "chain" not in fill[2]["sources"] or fill[2]["placed"] != FILL_PODS:
        raise AssertionError("mesh fill: %d placed, sources %s"
                             % (fill[2]["placed"], fill[2]["sources"]))
    out["fill_2x2"] = fill[2]
    # gang_anti's first cycle: intra-batch topology, the replicated surface
    anti = [mesh_drive(anti_world, "lax", 1000, shape, max_cycles=1)
            for shape in (None, (2, 2))]
    _same_drive(anti[0], anti[1], "mesh gang_anti")
    drives.append(anti[1][2])
    if anti[1][2]["tiled"]["auctions"]:
        raise AssertionError("mesh gang_anti: a topology batch tiled")
    out["gang_anti_first_cycle"] = dict(single=anti[0][2], mesh=anti[1][2])
    # seq_slice's first 256 pods: the replicated scan
    seq = [mesh_drive(_seq_first, None, 256, shape)
           for shape in (None, (2, 2))]
    _same_drive(seq[0], seq[1], "mesh seq_slice")
    drives.append(seq[1][2])
    out["seq_slice_256"] = dict(single=seq[0][2], mesh=seq[1][2])
    # the resident cluster under churn at (2, 2): verify() after every
    # refresh, the same digests; its first delta scatters again shard by
    # shard over the mesh, against the single-device scatter
    res = [resident_drain(1000, 100, 8, "lax", "cuda", digest=True,
                          mesh_shape=None)]
    with ScatterProbe() as scatters:
        res.append(resident_drain(1000, 100, 8, "lax", "cuda", digest=True,
                                  mesh_shape=(2, 2)))
    n_scatter = check_sharded_scatter(scatters.records, (2, 2))
    if not n_scatter:
        raise AssertionError("mesh resident: no delta scatter to check")
    if res[0][:2] != res[1][:2]:
        raise AssertionError("mesh resident: placements or evictions "
                             "differ")
    if res[0][3] != res[1][3]:
        raise AssertionError("mesh resident: refresh outcomes, uid lists "
                             "or resident digests differ")
    if "delta" not in res[1][2]["sources"]:
        raise AssertionError("mesh resident: no delta refresh")
    drives.append(res[1][2])
    out["resident_2x2"] = dict(single=res[0][2], mesh=res[1][2],
                               refreshes=len(res[1][3]),
                               verified=res[1][2]["verified"],
                               sharded_scatters_checked=n_scatter)
    # a small seeded world through the mesh, card against CPU
    small_card = mesh_drive(_mesh_small_world, "lax", 128, (2, 2))
    with cpu_threads():
        small_cpu = mesh_drive(_mesh_small_world, "lax", 128, (2, 2),
                               device="cpu")
    _same_drive(small_cpu, small_card, "mesh small card vs CPU")
    drives.append(small_card[2])
    out["small_card_vs_cpu"] = dict(card=small_card[2], matches_cpu=True)
    # K1's count over the mesh drives, each zeroed before it and read
    # after it
    out["launches"] = sum(d["launches"] for d in drives)
    if out["launches"]:
        raise AssertionError("mesh: K1 launched %d times under a mesh"
                             % out["launches"])
    import torch
    out["card_count"] = torch.cuda.device_count()
    out["matches_single_device"] = True
    return out

# ---------------------------------------------------------------------------
# custom profiles: the configurable scorers and the extension points


def autoscaler_profile():
    """Upstream's ClusterAutoscalerProvider as a profile: LeastAllocated
    disabled, MostAllocated enabled at weight 1."""
    from kubetpu_torch.apis import config as C
    return C.KubeSchedulerProfile(plugins=C.Plugins(score=C.PluginSet(
        enabled=[C.Plugin("NodeResourcesMostAllocated", 1)],
        disabled=[C.Plugin("NodeResourcesLeastAllocated")])))


def binpack_profile():
    """The default set plus RequestedToCapacityRatio with the plugin's
    default arguments (shape {0: 0, 100: 10}, cpu and memory at weight 1)
    and NodeResourceLimits."""
    from kubetpu_torch.apis import config as C
    return C.KubeSchedulerProfile(plugins=C.Plugins(score=C.PluginSet(
        enabled=[C.Plugin("RequestedToCapacityRatio", 1),
                 C.Plugin("NodeResourceLimits", 1)])))


def profile_scores(profile):
    """The tensor score plugins and weights a profile's Framework runs."""
    from kubetpu_torch.framework.runtime import Framework
    from kubetpu_torch.plugins.intree import new_in_tree_registry
    return Framework(new_in_tree_registry(), profile).tensor_scores


def phase_autoscaler() -> dict:
    """Preemption5000Nodes' init phase under the ClusterAutoscaler
    profile, gang, under "pallas" and "lax": the same placements, every
    filler placed, K1 launched through the generic combine only, every
    recorded launch equal to the plain version, no capacity violated."""
    out, stores = _pallas_vs_lax("autoscaler", fill_world, 1000,
                                 record_limit=16,
                                 profile=autoscaler_profile())
    pallas = out["pallas"]
    if pallas["launches_by_combine"] != {"generic": pallas["launches"]}:
        raise AssertionError("autoscaler: K1 launches by combine %s"
                             % pallas["launches_by_combine"])
    for backend, store in stores.items():
        if out[backend]["placed"] != FILL_PODS:
            raise AssertionError("autoscaler: %d/%d pods placed (%s)"
                                 % (out[backend]["placed"], FILL_PODS,
                                    backend))
    out["scores"] = [list(x) for x in profile_scores(autoscaler_profile())]
    return out


def phase_binpack() -> dict:
    """SchedulingBasic5000Nodes under the bin-packing profile: the
    sequential replay on the card (every scan under "error"), held
    against the CPU replay, the same placements and start index; the
    replay's launches and
    device ms per step over a profiled window; and the same world in gang
    mode under "pallas", routed to the lax round for its
    RequestedToCapacityRatio score."""
    sched, placed, out = _seq_drain("binpack", hollow_store(5000, 1),
                                    pending_pods(1000, "measured"), 1000,
                                    profile=binpack_profile())
    out.update(_seq_card_vs_cpu("binpack", placed, sched))
    out.update(window=_profiled_scan_window(
        hollow_store(5000, 1), pending_pods(1000, "measured"),
        sched_profile=binpack_profile()))
    _, gang = _gang_drain("binpack gang", hollow_store(5000, 1),
                          pending_pods(1000, "measured"), 1000,
                          profile=binpack_profile())
    want = ("lax", "score:RequestedToCapacityRatio")
    if any(tuple(r) != want for r in gang["routes"]):
        raise AssertionError("binpack gang: routes %s" % gang["routes"])
    out["gang"] = gang
    out["launches"] += gang["launches"]
    out["scores"] = [list(x) for x in profile_scores(binpack_profile())]
    return out


POINTS_FAIL_AT = {"p6": "Reserve", "p9": "Permit", "p13": "PreBind"}


def points_drain(device, mode, terms, record=None):
    """kubetpu_torch/harness/plugin_worlds.py's world (48 nodes x 200
    pods) under its profile, with the recording plugin at every point and
    an injected Reserve, Permit and PreBind failure, drained in batches of
    64 on ``device`` (gang under "pallas"; on the card every scan or
    auction under the sync checks) with binding on the binder pool and
    the queue's clock stopped (a failed pod stays out).  Returns
    (placements, per-pod calls, forgotten assumes, routes)."""
    from kubetpu_torch.api import types as A
    from kubetpu_torch.apis import config as C
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.framework import interface as fw
    from kubetpu_torch.harness import plugin_worlds as PW
    from kubetpu_torch.plugins.intree import new_in_tree_registry
    from kubetpu_torch.scheduler import Scheduler
    calls = []
    registry = dict(new_in_tree_registry())
    registry[PW.POINTS] = PW.points_plugin(fw, 7, calls, POINTS_FAIL_AT)
    cfg = C.KubeSchedulerConfiguration(
        profiles=[PW.profile(C, scorers=terms)], batch_size=64, mode=mode,
        kernel_backend="pallas")
    store = ClusterStore()
    sched = Scheduler(store, config=cfg, registry=registry, device=device,
                      async_binding=True)
    t0 = sched.queue._clock()
    sched.queue._clock = lambda: t0
    forgotten = []
    forget = sched.cache.forget_pod

    def spy(pod):
        forgotten.append(pod.metadata.name)
        return forget(pod)
    sched.cache.forget_pod = spy
    nodes, existing, pending, services = PW.world(A, 7, 48, 200, terms)
    PW.populate(store, nodes, existing, services)
    for p in pending:
        store.add(p)
    check = (contextlib.nullcontext() if device == "cpu"
             else GangRounds() if mode == "gang" else SeqScans())
    restore = (_record_launches(record, None)
               if record is not None else None)
    try:
        with check:
            for _ in range(20):
                out = sched.schedule_pending()
                sched.wait_for_inflight_binds(timeout=120.0)
                if not out:
                    break
    finally:
        if restore is not None:
            restore()
    sched.close()
    check_no_recovery(sched, "points %s %s" % (mode, device))
    placed = {p.metadata.name: p.spec.node_name for p in store.list("Pod")}
    return placed, PW.per_pod(calls), sorted(forgotten), sched.gang_backends


def phase_points() -> dict:
    """The plugin world, term-free and term-bearing, in both modes, card
    against CPU: the same placements, the same per-pod sequence of
    extension-point calls, the same Unreserve calls and forgotten
    assumes at the injected failures, the Permit pairs bound; K1 launched
    on the term-free gang drains with the host_ok and bias planes, every
    launch equal to the plain version."""
    from kubetpu_torch.harness import plugin_worlds as PW
    from kubetpu_torch.ops import propose as PK
    out = {"launches": 0}
    for terms in (False, True):
        for mode in ("gang", "sequential"):
            what = "points %s %s" % (mode, "terms" if terms else "term-free")
            record = [] if mode == "gang" and not terms else None
            PK.propose.launches = 0      # this path starts: zero the count
            t = time.perf_counter()
            card = points_drain("cuda", mode, terms, record)
            card_s = time.perf_counter() - t
            launches = PK.propose.launches
            t = time.perf_counter()
            with cpu_threads():
                cpu = points_drain("cpu", mode, terms)
            cpu_s = time.perf_counter() - t
            for i, name in enumerate(("placements", "calls", "forgotten",
                                      "routes")):
                if card[i] != cpu[i]:
                    raise AssertionError("%s: %s differ card vs CPU"
                                         % (what, name))
            placed, calls, forgotten, routes = card
            if set(forgotten) != {"p9", "p13"}:
                raise AssertionError("%s: forgotten %s" % (what, forgotten))
            if not all(placed["p%d" % i] for i in range(2 * PW.PAIRS)):
                raise AssertionError("%s: a Permit pair did not bind"
                                     % what)
            unreserved = sorted(p for p, seq in calls.items()
                                if any(pt == "Unreserve" for pt, _ in seq))
            if unreserved != ["p13", "p6", "p9"]:
                raise AssertionError("%s: unreserved %s" % (what, unreserved))
            res = dict(placed=sum(1 for v in placed.values() if v),
                       card_s=card_s, cpu_s=cpu_s, launches=launches,
                       calls=sum(len(v) for v in calls.values()),
                       routes=sorted({r for r, _ in routes}))
            if record is not None:
                if launches <= 0:
                    raise AssertionError("%s: K1 never launched" % what)
                if not all("bias" in ins[0]["layout"].planes
                           and not bool(ins[0]["mask"].all())
                           for ins, _ in record):
                    raise AssertionError("%s: a launch lacks the host "
                                         "planes" % what)
                res["recorded"] = check_recorded(record, what)
            out["launches"] += launches
            out[what] = res
    return out


# ---------------------------------------------------------------------------
# serving: the pipelined executor, cycle recovery, Scheduler.run, the CLI
# and the REST store

SERVE_DEPTHS = (1, 2, 4)
REST_NODES, REST_PODS = 1000, 2000     # serving's and chaos' REST world
SERVE_DEADLINE_S = 10.0     # armed on every serving drain: no demotion


def serve_sched(store, batch_size, depth, pipelined=True, **cfg_kw):
    """A gang scheduler under "pallas" with the chain on, the depth-k
    pipelined executor (pipelined=False: the synchronous drain) and the
    dispatch deadline armed, on the card, on a frozen queue clock."""
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.scheduler import Scheduler
    cfg_kw.setdefault("dispatch_deadline_seconds", SERVE_DEADLINE_S)
    cfg = KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=batch_size,
        mode="gang", kernel_backend="pallas", chain_cycles=True,
        pipeline_cycles=pipelined, pipeline_depth=depth, **cfg_kw)
    sched = Scheduler(store, config=cfg, device="cuda")
    sched.queue._clock = _QueueClock()
    return sched


def serve_passes(sched, max_passes=8):
    """Drain in passes on the frozen queue clock: a pass pops until the
    queue runs dry and flushes the pipeline; then the clock passes every
    backoff and the unschedulable leftover timeout and the next pass
    retries what failed.  So the synchronous and the pipelined drains pop
    the same pods in the same cycles.  Ends after a pass that binds
    nothing.  Returns the outcomes."""
    outs = []
    for _ in range(max_passes):
        bound = 0
        while True:
            got = sched.schedule_pending()
            outs.extend(got)
            bound += sum(1 for o in got if o.node)
            if not got and not len(sched._pipeline.ring):
                break
        got = sched.flush_pipeline()
        outs.extend(got)
        bound += sum(1 for o in got if o.node)
        if not bound:
            break
        sched.queue._clock.t += 1000.0
        sched.queue.flush_backoff_completed()
        sched.queue.flush_unschedulable_leftover()
    return outs


def serve_drain(store, pods, batch_size, depth, pipelined=True, record=None,
                **cfg_kw):
    """One drain of ``pods`` through serve_sched and serve_passes, every
    K1 launch recorded (record).  Reports the drain's seconds, stages,
    the host seconds exempted from the deadline (summed over cycles),
    cycles, rounds, the ring's high-water mark and the re-run cycles.
    Fails on any recovery or demotion."""
    sched = serve_sched(store, batch_size, depth, pipelined, **cfg_kw)
    exempt = []
    commit = sched._commit_group

    def commit_spy(prep, packed):
        exempt.append(prep.host_exempt_s)
        return commit(prep, packed)
    sched._commit_group = commit_spy
    for p in pods:
        store.add(p)
    restore = (_record_launches(record, None) if record is not None
               else None)
    try:
        t0 = time.perf_counter()
        outs = serve_passes(sched)
        seconds = time.perf_counter() - t0
    finally:
        if restore is not None:
            restore()
        sched.close()
    check_no_recovery(sched, "serving drain (depth %d)" % depth)
    if sched.preempt_wave_failures:
        raise AssertionError("serving drain: %d preemption waves failed"
                             % sched.preempt_wave_failures)
    stats = dict(depth=depth if pipelined else "sync", drain_s=seconds,
                 stage_s=dict(sched.stage_s),
                 host_exempt_s=sum(exempt),
                 cycles=sched.cycle_count, rounds=sum(sched.gang_rounds),
                 routes=sorted({b for b, _ in sched.gang_backends}),
                 ring_high_water=sched._pipeline.ring.high_water,
                 reruns=sched._pipeline.reruns,
                 chain_uses=sched.cluster_sources.count("chain"),
                 sources=list(sched.cluster_sources))
    return sched, outs, stats


def _serve_depths(what, make_world, batch_size, depths=SERVE_DEPTHS,
                  reps=2, record=True):
    """The world drained synchronously and pipelined at every depth of
    ``depths``, each ``reps`` times: every drain binds the same pod ->
    node map; with record, every K1 launch of every drain is held to the
    plain version and each drain launches K1 as often as the
    synchronous one."""
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.scheduler import capacity_violations
    runs, want = [], None
    for depth, pipelined in [(1, False)] + [(d, True) for d in depths
                                            for _ in range(reps)]:
        store, pods = make_world()
        rec = [] if record else None
        PK.propose.launches = 0          # this path starts: zero the count
        _, _, stats = serve_drain(store, pods, batch_size, depth, pipelined,
                                  rec)
        stats["launches"] = PK.propose.launches
        placed = placements_of(store)
        bad = capacity_violations(store)
        if bad:
            raise AssertionError("%s (%s): capacity violated on %d nodes"
                                 % (what, stats["depth"], len(bad)))
        if want is None:
            want, sync = placed, stats
        elif placed != want:
            diff = sum(1 for k in want if placed.get(k) != want[k])
            raise AssertionError("%s: depth %d binds %d pods elsewhere than "
                                 "the synchronous drain"
                                 % (what, depth, diff))
        if record:
            if stats["launches"] != sync["launches"]:
                raise AssertionError(
                    "%s: depth %d launched K1 %d times, the synchronous "
                    "drain %d" % (what, depth, stats["launches"],
                                  sync["launches"]))
            if stats["launches"]:
                stats["recorded"] = check_recorded(rec, "%s depth %s"
                                                   % (what, stats["depth"]))
        stats["bound"] = sum(1 for v in placed.values() if v)
        stats.pop("sources")
        runs.append(stats)
        log({"serving_drain": what, **stats})
    return runs


def _serve_fault(kind, fail_at, n_nodes=1000, batch_size=512):
    """A seeded 1,000-node pipelined drain (the backlog's world, batch
    512) whose ``fail_at``-th auction fails.  kind "error": at depth 2,
    it raises; kind "stall": at depth 3, with a 2 s deadline, it sleeps
    3 s first, so its readback finds the deadline blown; the first cycle
    stalls, since the second is dispatched on its chain and is in flight
    at that readback.  The recovery is recorded with its reason and
    nothing is demoted (every cycle, before and after it, on the kernel
    route), the cycle's pods are requeued, after the stall the younger
    cycle is re-run (``PipelinedExecutor.reruns``); every pod ends bound
    exactly once (a store that counts binds), four on every node; no
    capacity violated."""
    import kubetpu_torch.scheduler as S
    from kubetpu_torch.scheduler import capacity_violations
    from kubetpu_torch.utils import pallas_backend as PB
    src_store, pods = backlog_world() if n_nodes == 1000 else (
        hollow_store(n_nodes, 3, varied=True),
        pending_pods(4 * n_nodes, "backlog", cpu_milli=900))
    store = counting_store(src_store)
    orig, calls = S.run_auction, [0]

    def faulty(*args, **kw):
        calls[0] += 1
        if calls[0] == fail_at:
            if kind == "error":
                raise RuntimeError("injected dispatch fault")
            time.sleep(3.0)
        return orig(*args, **kw)
    S.run_auction = faulty
    try:
        if kind == "error":
            sched = serve_sched(store, batch_size, 2)
        else:
            sched = serve_sched(store, batch_size, 3,
                                dispatch_deadline_seconds=2.0)
        reprepared = [0]
        reprepare = sched._pipeline._reprepare

        def counted(prep):
            reprepared[0] += 1
            return reprepare(prep)
        sched._pipeline._reprepare = counted
        for p in pods:
            store.add(p)
        outs = serve_passes(sched)
    finally:
        S.run_auction = orig
        sched.close()
    want = {"error": ("dispatch-error", "injected dispatch fault"),
            "stall": ("dispatch-deadline", "> deadline")}[kind]
    log_ = list(sched.recovery_log)
    if (len(log_) != 1 or log_[0]["kind"] != want[0]
            or want[1] not in log_[0]["reason"]):
        raise AssertionError("fault %s: recovery log %s" % (kind, log_))
    if PB.demotion() is not None:
        raise AssertionError("fault %s: demotion %r" % (kind, PB.demotion()))
    routes = [b for b, _ in sched.gang_backends]
    if set(routes) != {"pallas"}:
        raise AssertionError("fault %s: routes %s"
                             % (kind, sorted(set(routes))))
    requeued = [o for o in outs if o.err and "dispatch recovered" in o.err]
    if len(requeued) != log_[0]["pods"] or not requeued:
        raise AssertionError("fault %s: %d pods requeued, the log says %d"
                             % (kind, len(requeued), log_[0]["pods"]))
    if kind == "stall" and sched._pipeline.reruns < 1:
        raise AssertionError("fault stall: no younger cycle was re-run")
    if len(store.bind_calls) != len(set(store.bind_calls)):
        raise AssertionError("fault %s: a pod was bound twice" % kind)
    bound = {p.metadata.name for p in store.list("Pod")
             if p.spec.node_name and p.metadata.name.startswith("backlog")}
    if bound != set(store.bind_calls):
        raise AssertionError("fault %s: binds and bound pods differ" % kind)
    bad = capacity_violations(store)
    if bad:
        raise AssertionError("fault %s: capacity violated on %d nodes"
                             % (kind, len(bad)))
    # each node fits four 900m pods beside its 0-3 100m ones
    if len(bound) != 4 * n_nodes:
        raise AssertionError("fault %s: %d pods bound, %d expected"
                             % (kind, len(bound), 4 * n_nodes))
    return dict(recovery=log_[0], requeued=len(requeued),
                reruns=sched._pipeline.reruns, reprepared=reprepared[0],
                bound=len(bound), binds=len(store.bind_calls),
                cycles=sched.cycle_count, routes=sorted(set(routes)))


def _http_get(port, path):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _serve_run(n_nodes=5000, n_pods=5000, depth=2, timeout_s=300.0):
    """Scheduler.run() and SchedulerServer on the card: 5,000 hollow nodes,
    5,000 pending pods and one that fits nowhere, gang under "pallas",
    pipelined at depth 2, binding on the pool.  Waits (bounded) until
    every pod is bound; /healthz, /metrics (the cycle counters) and
    /debug/explain for a bound and the unschedulable pod answer; close()
    returns within its join bound."""
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.harness import hollow
    from kubetpu_torch.scheduler import Scheduler, capacity_violations
    from kubetpu_torch.server import SchedulerServer
    from kubetpu_torch.utils.metrics import SchedulerMetrics
    store = hollow_store(n_nodes, 0)
    metrics = SchedulerMetrics()
    sched = Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=1000, mode="gang",
        kernel_backend="pallas", pipeline_cycles=True, pipeline_depth=depth,
        dispatch_deadline_seconds=SERVE_DEADLINE_S),
        device="cuda", metrics=metrics, async_binding=True)
    server = SchedulerServer(sched, port=0)
    port = server.start()
    try:
        for p in pending_pods(n_pods, "served"):
            store.add(p)
        store.add(hollow.make_pod("huge", cpu_milli=10 ** 6))
        t0 = time.perf_counter()
        sched.run()
        prewarm_s = time.perf_counter() - t0
        deadline = time.perf_counter() + timeout_s
        bound = 0
        while time.perf_counter() < deadline:
            bound = sum(1 for p in store.list("Pod") if p.spec.node_name)
            if bound == n_pods and sched.decisions.get("huge") is not None:
                break
            time.sleep(0.1)
        seconds = time.perf_counter() - t0
        if bound != n_pods:
            raise AssertionError("served: %d/%d pods bound in %.0f s"
                                 % (bound, n_pods, timeout_s))
        if store.get_pod("default", "huge").spec.node_name:
            raise AssertionError("served: the oversized pod was bound")
        if capacity_violations(store):
            raise AssertionError("served: capacity violated")
        health = _http_get(port, "/healthz")
        code, text = _http_get(port, "/metrics")
        want = ('scheduler_schedule_attempts_total{result="scheduled"} %d.0'
                % n_pods)
        if (health != (200, "ok") or code != 200
                or "scheduler_device_batch_size_count" not in text
                or want not in text):
            raise AssertionError("served: /healthz %s, /metrics %d"
                                 % (health, code))
        explained = {}
        # the DecisionLog is bounded: ask for the last pod popped
        for pod, outcome in (("served-%d" % (n_pods - 1), "scheduled"),
                             ("huge", "unschedulable")):
            code, body = _http_get(port, "/debug/explain?pod=" + pod)
            doc = json.loads(body)
            if code != 200 or doc["outcome"] != outcome:
                raise AssertionError("served: /debug/explain?pod=%s: %d %s"
                                     % (pod, code, body[:200]))
            explained[pod] = doc["outcome"]
    finally:
        t1 = time.perf_counter()
        sched.close()
        server.stop()
        close_s = time.perf_counter() - t1
    if close_s > 10.0 or sched._serve_thread is not None:
        raise AssertionError("served: close() took %.1f s" % close_s)
    check_no_recovery(sched, "served")
    return dict(bound=bound, seconds=seconds, prewarm_s=prewarm_s,
                close_s=close_s, cycles=sched.cycle_count,
                stage_s=dict(sched.stage_s), explained=explained,
                ring_high_water=sched._pipeline.ring.high_water)


PIPELINED_YAML = """apiVersion: kubescheduler.config.k8s.io/v1beta1
kind: KubeSchedulerConfiguration
mode: gang
batchSize: 1000
kernelBackend: pallas
pipelineCycles: true
pipelineDepth: 2
"""


def _cli(args, timeout_s=600):
    """python -m kubetpu_torch as a subprocess on the card (its JSON lines
    and exit code); the kernel library built above is reused."""
    import os
    import torch
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "kubetpu_torch"] + args,
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=timeout_s)
    if out.returncode != 0:
        raise AssertionError("python -m kubetpu_torch %s: exit %d\n%s"
                             % (" ".join(args), out.returncode,
                                out.stderr[-3000:]))
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def _serve_cli(n_nodes=5000, n_pods=5000):
    """``python -m kubetpu_torch --once`` on its own hollow world with the
    pipelined configuration: its JSON line's ``scheduled`` equals what
    the same world's in-process drain binds."""
    import os
    import tempfile
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.harness import hollow
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "pipelined.yaml")
        with open(path, "w") as fh:
            fh.write(PIPELINED_YAML)
        t0 = time.perf_counter()
        lines = _cli(["--once", "--mode", "gang", "--hollow-nodes",
                      str(n_nodes), "--hollow-pods", str(n_pods),
                      "--config", path])
        seconds = time.perf_counter() - t0
    summary = lines[-1]
    # the same world in this process (as __main__ builds it)
    store = ClusterStore()
    for n in hollow.make_nodes(n_nodes, zones=8):
        store.add(n)
    pods = hollow.make_pods(n_pods, prefix="pend-", group_labels=16)
    _, outs, stats = serve_drain(store, pods, 1000, 2)
    in_process = sum(1 for p in store.list("Pod") if p.spec.node_name)
    if summary.get("scheduled") != in_process or in_process != n_pods:
        raise AssertionError("cli: scheduled %s, the in-process drain %d"
                             % (summary, in_process))
    return dict(summary=summary, subprocess_s=seconds,
                in_process_bound=in_process, in_process_s=stats["drain_s"])


def _serve_rest(n_nodes=REST_NODES, n_pods=REST_PODS, timeout_s=120.0):
    """The REST control plane in two processes: this one serves a hollow
    cluster through APIServer; ``python -m kubetpu_torch --api-server URL
    --once`` (pipelined configuration) schedules it over HTTP; this
    process's store sees every binding."""
    import os
    import tempfile
    from kubetpu_torch.client.rest import APIServer
    from kubetpu_torch.scheduler import capacity_violations
    store = hollow_store(n_nodes, 0)
    for p in pending_pods(n_pods, "rest"):
        store.add(p)
    api = APIServer(store)
    port = api.start()
    try:
        with tempfile.TemporaryDirectory(dir=os.path.dirname(
                os.path.abspath(__file__))) as tmp:
            path = os.path.join(tmp, "pipelined.yaml")
            with open(path, "w") as fh:
                fh.write(PIPELINED_YAML)
            t0 = time.perf_counter()
            lines = _cli(["--api-server", "http://127.0.0.1:%d" % port,
                          "--once", "--config", path])
            seconds = time.perf_counter() - t0
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            bound = sum(1 for p in store.list("Pod") if p.spec.node_name)
            if bound == n_pods:
                break
            time.sleep(0.1)
    finally:
        api.stop()
    if bound != n_pods or lines[-1].get("scheduled") != n_pods:
        raise AssertionError("rest: the server sees %d/%d bound; the "
                             "client says %s" % (bound, n_pods, lines[-1]))
    if capacity_violations(store):
        raise AssertionError("rest: capacity violated")
    return dict(server_bound=bound, client=lines[-1], subprocess_s=seconds)


def phase_serving() -> dict:
    """The serving loop on the card: the pipelined fill at every depth,
    once each, against the synchronous drain; vol_backlog pipelined
    (the host-filter flush path) against its synchronous drain; an
    injected dispatch error and a stall past the deadline; Scheduler.run
    with SchedulerServer; the CLI;
    the REST store in two processes."""
    from kubetpu_torch.ops import propose as PK
    launches = 0
    # once per depth (the run's time limit: the extenders and chaos
    # phases need the room)
    fill = _serve_depths("fill", fill_world, 1000, reps=1)
    launches += sum(r["launches"] for r in fill)
    if fill[-1]["ring_high_water"] != 3:
        raise AssertionError("serving: the depth-4 ring reached %d parked "
                             "cycles" % fill[-1]["ring_high_water"])
    vol = _serve_depths("vol_backlog", vol_backlog_world, 1024, depths=(2,),
                        reps=1)
    launches += sum(r["launches"] for r in vol)
    recorded = [r["recorded"] for r in fill + vol if "recorded" in r]
    PK.propose.launches = 0
    fault = dict(error=_serve_fault("error", 3), stall=_serve_fault("stall", 1))
    with LoggedFaults("served"):
        served = _serve_run()
    # the CLI and the REST store, each in processes of its own (run
    # beside the earlier phases by main())
    cli, cli_wait = child_result("serving cli", _serve_cli)
    rest, rest_wait = child_result("serving rest", _serve_rest)
    return dict(launches=launches, fill=fill, vol_backlog=vol, fault=fault,
                served=served, cli=cli, rest=rest,
                card_wait_s=cli_wait + rest_wait,
                recorded=dict(checked=sum(r["checked"] for r in recorded),
                              max_abs_err=max(r["max_abs_err"]
                                              for r in recorded),
                              real_launch=recorded[0]["real_launch"]))


# ---------------------------------------------------------------------------
# HTTP extenders and injected faults

EXT_NODES = 5000     # SchedulingBasic5000Nodes (config/performance-config.yaml:9-13)
EXT_PODS = 1000      # its measured pods
EXT_PREEMPT_NODES = 500   # Preemption (:158-162): 500 nodes, 2,000 fillers
# the extender drain's cycles held on the CPU, in pairs (k, k + 1) spread
# over the whole drain, each pair replayed from the card's state before
# cycle k: the CPU's filter-and-score at N = P = 8,192 costs ~8 s per pod,
# so the CPU cannot drain all 1,000 pods within the run
EXT_REPLAY_AT = (0, 142, 284, 426, 568, 710, 852, 998)
CHAOS_SPEC = "seed=42,dispatch:error:n=1,delta:corrupt:n=1,bind:error:n=1"
CHAOS_REST_SPEC = "seed=42,rest:error:n=2,watch:error:n=2"
# the recovery_log entries the chaos drains expect (a bind retry is not
# one: the JAX scheduler counts it in recoveries{bind-retry} only)
CHAOS_RECOVERIES = {"dispatch-error", "verify-resync"}


def event_counts(store) -> dict:
    """Events by reason."""
    out = {}
    for e in store.list("Event"):
        out[e.reason] = out.get(e.reason, 0) + 1
    return out


def check_scheduled_events(store, bound, what) -> int:
    """One Scheduled Event, of count 1, per pod the drain bound."""
    evs = [e for e in store.list("Event") if e.reason == "Scheduled"]
    names = sorted(e.involved_name for e in evs)
    if names != sorted(bound) or any(e.count != 1 for e in evs):
        raise AssertionError("%s: %d Scheduled Events for %d bound pods"
                             % (what, len(evs), len(bound)))
    return len(evs)


class PreemptTally:
    """What a drain's preemption did, counted beside the metrics: the pods
    each Preempt call was handed (every one eligible: a hollow store
    deletes at once, so no victim is ever terminating) and each committed
    preemption's victims."""

    def __init__(self, sched):
        self.attempts = 0
        self.victims = []
        pre = sched.preemptor
        wave, commit = pre.preempt_wave, pre._commit_victims

        def preempt_wave(fwk, cycle, pods):
            self.attempts += len(pods)
            return wave(fwk, cycle, pods)

        def commit_victims(fwk, pod, best, victims, cycle, node_row):
            self.victims.append(len(victims.pods))
            return commit(fwk, pod, best, victims, cycle, node_row)
        pre.preempt_wave = preempt_wave
        pre._commit_victims = commit_victims


def check_preemption_observed(what, metrics, tally, store, deleted) -> dict:
    """preemption_attempts_total and the preemption_victims count and sum
    equal the drain's own tallies, and one Preempted Event names each
    evicted pod."""
    victims = [v for v in tally.victims if v]
    got = (metrics.preemption_attempts.value(),
           metrics.preemption_victims.count(),
           metrics.preemption_victims.sum())
    if got != (tally.attempts, len(victims), sum(victims)) \
            or sum(victims) != len(deleted):
        raise AssertionError("%s: preemption metrics %s, tallies %s, %d "
                             "evicted" % (what, got, (tally.attempts,
                                                      len(victims),
                                                      sum(victims)),
                                          len(deleted)))
    evs = [e for e in store.list("Event") if e.reason == "Preempted"]
    if sorted(e.involved_name for e in evs) != sorted(d[0] for d in deleted):
        raise AssertionError("%s: %d Preempted Events for %d evictions"
                             % (what, len(evs), len(deleted)))
    return dict(attempts=tally.attempts, preemptions=len(victims),
                victims=sum(victims), preempted_events=len(evs))


def ext_decision_view(sched, url) -> dict:
    """Every pod's last decision, its extenders map with the extender's
    URL written "EXT" (the card's and the CPU's extenders listen on
    other ports)."""
    return {d.name: (d.outcome, d.node, d.n_feasible, d.nominated_node,
                     d.message, {k.replace(url, "EXT"): v
                                 for k, v in d.extenders.items()})
            for d in sched.decisions.recent(10 ** 6)}


def _extender_sched(store, ext, device):
    """The default configuration with ``ext`` (a FakeExtender) as its one
    extender, on ``device``."""
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.scheduler import Scheduler
    from kubetpu_torch.utils.metrics import SchedulerMetrics
    return Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=1000,
        extenders=[ext.config()]), device=device, metrics=SchedulerMetrics())


def _measured_placed(store) -> dict:
    return {p.metadata.name: p.spec.node_name for p in store.list("Pod")
            if p.metadata.labels.get("group") == "measured"
            and p.spec.node_name}


def extender_drain(device, n_nodes=EXT_NODES, n_pods=EXT_PODS) -> dict:
    """SchedulingBasic5000Nodes (5,000 nodes, one bound pod each; its
    1,000 measured pods) under the default configuration with the fake
    extender (kubetpu_torch/harness/extender_worlds.py) serving filter,
    prioritize and bind: each pod its own cycle, scored once on the
    device and placed on the host.  Returns the bound pods' nodes, their
    decisions, the pod of each cycle in order, the scheduler's tie-break
    counter and cycle count before each cycle (and after the last), the
    extender's calls, cycles, seconds and stages."""
    import torch
    from kubetpu_torch.harness import extender_worlds as EW
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.scheduler import capacity_violations
    store = hollow_store(n_nodes, 1)
    pods = pending_pods(n_pods, "measured")
    with EW.FakeExtender(store, verbs=("filter", "prioritize",
                                       "bind")) as ext:
        sched = _extender_sched(store, ext, device)
        for p in pods:
            store.add(p)
        order, counters = [], []
        PK.propose.launches = 0          # this path starts: zero the count
        t0 = time.perf_counter()
        while True:
            counters.append((sched._rng_counter, sched.cycle_count))
            out = sched.schedule_pending()
            if not out:
                break
            order.extend(o.pod.metadata.name for o in out)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = PK.propose.launches
        sched.close()
        url, calls = ext.url, dict(ext.calls)
    check_no_recovery(sched, "extenders %s" % device)
    placed = _measured_placed(store)
    bound = list(placed)
    if (len(bound) != n_pods or len(order) != sched.cycle_count
            or capacity_violations(store)):
        raise AssertionError("extenders %s: %d/%d bound in %d cycles"
                             % (device, len(bound), n_pods,
                                sched.cycle_count))
    if any(EW.node_index(v) % 4 == 0 for v in placed.values()):
        raise AssertionError("extenders %s: a pod on a node the extender "
                             "filtered out" % device)
    if calls.get("bind") != n_pods:
        raise AssertionError("extenders %s: %s extender calls"
                             % (device, calls))
    return dict(placed=placed, decisions=ext_decision_view(sched, url),
                order=order, counters=counters, calls=calls,
                cycles=sched.cycle_count, seconds=seconds,
                stage_s=dict(sched.stage_s), launches=launches,
                scheduled_events=check_scheduled_events(
                    store, bound, "extenders %s" % device),
                events=event_counts(store))


def extender_cpu_replay(order, placed, counters, at=EXT_REPLAY_AT,
                        n_nodes=EXT_NODES, n_pods=EXT_PODS) -> dict:
    """The extender drain's cycles k and k + 1, for each k in ``at``, on
    the CPU, each pair from the card drain's state before cycle k: the
    pods of the card's first k cycles (``order``) bound where the card
    placed them (``placed``), pods k and k + 1 pending, and the
    scheduler's tie-break counter and cycle count as the card's were
    (``counters``).  Returns the replayed pods' nodes and decisions, the
    counters after each replayed cycle, cycles and seconds."""
    from kubetpu_torch.harness import extender_worlds as EW
    store = hollow_store(n_nodes, 1)
    pods = {p.metadata.name: p for p in pending_pods(n_pods, "measured")}
    after = {}
    seconds = 0.0
    with EW.FakeExtender(store, verbs=("filter", "prioritize",
                                       "bind")) as ext:
        sched = _extender_sched(store, ext, "cpu")
        done = 0
        for k in at:
            for name in order[done:k]:
                pods[name].spec.node_name = placed[name]
                store.add(pods[name])
            for name in order[k:k + 2]:
                store.add(pods[name])
            sched._rng_counter, sched.cycle_count = counters[k]
            t0 = time.perf_counter()
            for j in (k, k + 1):
                sched.schedule_pending()
                after[j + 1] = (sched._rng_counter, sched.cycle_count)
            seconds += time.perf_counter() - t0
            done = k + 2
        sched.close()
        url = ext.url
    check_no_recovery(sched, "extenders replay")
    names = [n for k in at for n in order[k:k + 2]]
    now = _measured_placed(store)
    view = ext_decision_view(sched, url)
    return dict(placed={n: now.get(n) for n in names},
                decisions={n: view.get(n) for n in names}, after=after,
                cycles=len(names), seconds=seconds)


def extender_preempt_drain(device, n_nodes=EXT_PREEMPT_NODES) -> dict:
    """scheduler_perf's Preemption (500 nodes packed with four fillers
    each, bound directly; as many preemptors as nodes) under the default
    configuration with a preemptVerb extender that keeps only the
    even-indexed candidates: placements, victims in order, nominations,
    decisions, the metrics against the drain's tallies, the Preempted
    Events."""
    from kubetpu_torch.harness import extender_worlds as EW
    from kubetpu_torch.utils.metrics import SchedulerMetrics
    store = packed_fill_store(n_nodes)
    pods = preemptor_pods(n_nodes)
    metrics = SchedulerMetrics()
    tallies = []
    with EW.FakeExtender(store, verbs=("preempt",)) as ext:
        sched, placed, deleted, noms, seconds, _ = _preempt_drain(
            store, pods, None, device, extenders=[ext.config()],
            metrics=metrics, on_sched=lambda s: tallies.append(
                PreemptTally(s)))
        url, calls = ext.url, dict(ext.calls)
    if any(EW.node_index(n) % 2 for n in noms.values()):
        raise AssertionError("extenders preempt %s: a nomination on a node "
                             "the extender dropped" % device)
    if not deleted or not calls.get("preempt"):
        raise AssertionError("extenders preempt %s: nothing preempted"
                             % device)
    observed = check_preemption_observed(
        "extenders preempt %s" % device, metrics, tallies[0], store, deleted)
    return dict(placed=placed, deleted=deleted, noms=noms,
                decisions=ext_decision_view(sched, url), calls=calls,
                cycles=sched.cycle_count, seconds=seconds,
                stage_s=dict(sched.stage_s), observed=observed)


def _differ(what, key, card, cpu) -> None:
    if card != cpu:
        diff = ([k for k in card if card[k] != cpu.get(k)]
                if isinstance(card, dict) else "-")
        raise AssertionError("%s: %s differ card vs CPU (%s)"
                             % (what, key, diff[:3]))


def phase_extenders() -> dict:
    """HTTP extenders on the card (main()'s card child, beside the phases
    after the kernel's), each drain held against the CPU (main()'s
    reference child): SchedulingBasic5000Nodes with filter, prioritize
    and bind, all 1,000 pods on the card and the EXT_REPLAY_AT cycle
    pairs replayed on the CPU from the card's state (every replayed pod's
    node and decision, its extenders map included, and the tie-break
    counter after each cycle equal); and Preemption with a preemptVerb
    extender, whole on both (the same victims in order, nominations,
    placements and decisions; the preemption metrics and Preempted
    Events against the drain's own tallies)."""
    card, card_wait = child_result("extenders card", extender_drain, "cuda")
    start_replay(card)
    cpu, cpu_wait = child_result("extenders replay", extender_cpu_replay,
                                 card["order"], card["placed"],
                                 card["counters"])
    names = list(cpu["placed"])
    _differ("extenders", "placed", {n: card["placed"][n] for n in names},
            cpu["placed"])
    _differ("extenders", "decisions",
            {n: card["decisions"][n] for n in names}, cpu["decisions"])
    _differ("extenders", "counters",
            {j: tuple(card["counters"][j]) for j in cpu["after"]},
            cpu["after"])
    n = len(card["placed"])
    out = dict(extenders=dict(
        pods=n, cycles=card["cycles"], card_s=card["seconds"],
        card_wait_s=card_wait, cpu_pods=len(names), cpu_cycles=cpu["cycles"],
        cpu_replayed_at=list(EXT_REPLAY_AT), cpu_s=cpu["seconds"],
        cpu_wait_s=cpu_wait, stage_s=card["stage_s"], calls=card["calls"],
        round_trips_per_pod=sum(card["calls"].values()) / n,
        matches_cpu=True, launches=card["launches"],
        scheduled_events=card["scheduled_events"], events=card["events"]))
    card, card_wait = child_result("extenders_preempt card",
                                   extender_preempt_drain, "cuda")
    cpu, cpu_wait = child_result("extenders_preempt cpu",
                                 extender_preempt_drain, "cpu")
    for key in ("placed", "deleted", "noms", "decisions", "calls"):
        _differ("extenders_preempt", key, card[key], cpu[key])
    n = len(card["placed"])
    out["extenders_preempt"] = dict(
        pods=n, cycles=card["cycles"], card_s=card["seconds"],
        card_wait_s=card_wait, cpu_pods=len(cpu["placed"]),
        cpu_cycles=cpu["cycles"], cpu_s=cpu["seconds"], cpu_wait_s=cpu_wait,
        stage_s=card["stage_s"], calls=card["calls"],
        round_trips_per_pod=sum(card["calls"].values()) / n,
        matches_cpu=True, deleted=len(card["deleted"]),
        nominated=len(card["noms"]), **card["observed"])
    out["launches"] = out["extenders"]["launches"]
    return out


def _chaos_backlog(device="cuda", n_nodes=1000, batch_size=512) -> dict:
    """The backlog's world (1,000 nodes, 4,096 900m pods) gang under
    "pallas", batch 512, the chain on, on an in-process store, with
    KUBETPU_VERIFY_INTERVAL=1 and KUBETPU_CHAOS=CHAOS_SPEC read by the
    Scheduler (utils/chaos.maybe_arm_from_env): the first dispatch
    raises, the first delta scatter corrupts a resident, the first bind
    fails.  Every armed point fired, every pod bound exactly once, the
    recoveries logged (dispatch-error, verify-resync) and counted
    (bind-retry too), faults_injected equal to the fire counts, no
    demotion, every K1 launch recorded and bitwise equal to the plain
    version."""
    import os
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.scheduler import Scheduler, capacity_violations
    from kubetpu_torch.utils import chaos
    from kubetpu_torch.utils import pallas_backend as PB
    from kubetpu_torch.utils.metrics import SchedulerMetrics
    src, pods = ((backlog_world() if n_nodes == 1000 else
                  (hollow_store(n_nodes, 3, varied=True),
                   pending_pods(4 * n_nodes + n_nodes // 10, "backlog",
                                cpu_milli=900))))
    store = counting_store(src)
    metrics = SchedulerMetrics()
    env = {"KUBETPU_CHAOS": CHAOS_SPEC, "KUBETPU_VERIFY_INTERVAL": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    record = []
    try:
        sched = Scheduler(store, config=KubeSchedulerConfiguration(
            profiles=[KubeSchedulerProfile()], batch_size=batch_size,
            mode="gang", kernel_backend="pallas", chain_cycles=True),
            device=device, metrics=metrics)
        reg = chaos.active()
        if reg is None or reg.seed != 42:
            raise AssertionError("chaos: KUBETPU_CHAOS did not arm the "
                                 "registry")
        sched.queue._clock = _QueueClock()
        for p in pods:
            store.add(p)
        restore = (_record_launches(record, None) if device == "cuda"
                   else lambda: None)
        PK.propose.launches = 0          # this path starts: zero the count
        try:
            with (GangRounds() if device == "cuda"
                  else contextlib.nullcontext()) as gr:
                t0 = time.perf_counter()
                outs = serve_passes(sched)
                seconds = time.perf_counter() - t0
        finally:
            restore()
            sched.close()
        launches = PK.propose.launches
        sched._sync_chaos_metrics()
        fired = reg.counts()
    finally:
        chaos.disarm()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    what = "chaos backlog"
    if fired != {"dispatch": 1, "delta": 1, "bind": 1}:
        raise AssertionError("%s: fired %s" % (what, fired))
    kinds = [e["kind"] for e in sched.recovery_log]
    if sorted(kinds) != sorted(CHAOS_RECOVERIES):
        raise AssertionError("%s: recovery log %s" % (what, kinds))
    retries = metrics.recoveries.value("bind-retry")
    if retries != 1 or event_counts(store).get("BindRetried") != 1:
        raise AssertionError("%s: %s bind retries counted" % (what, retries))
    injected = {pt: metrics.faults_injected.value(pt) for pt in fired}
    if injected != fired:
        raise AssertionError("%s: faults_injected %s, fired %s"
                             % (what, injected, fired))
    if PB.demotion() is not None or {b for b, _ in sched.gang_backends} \
            != {"pallas"}:
        raise AssertionError("%s: routes %s, demotion %r" % (
            what, sorted({b for b, _ in sched.gang_backends}),
            PB.demotion()))
    if len(store.bind_calls) != len(set(store.bind_calls)):
        raise AssertionError("%s: a pod was bound twice" % what)
    bound = sorted(p.metadata.name for p in store.list("Pod")
                   if p.spec.node_name and p.metadata.name.startswith(
                       "backlog"))
    if bound != sorted(store.bind_calls) or len(bound) != 4 * n_nodes:
        raise AssertionError("%s: %d pods bound, %d binds"
                             % (what, len(bound), len(store.bind_calls)))
    if capacity_violations(store):
        raise AssertionError("%s: capacity violated" % what)
    requeued = sum(1 for o in outs if o.err and "dispatch recovered" in o.err)
    out = dict(fired=fired, faults_injected=injected, recoveries=kinds,
               bind_retries=retries, requeued=requeued, bound=len(bound),
               cycles=sched.cycle_count, sources=sched.cluster_sources,
               launches=launches, seconds=seconds,
               scheduled_events=check_scheduled_events(store, bound, what))
    if device == "cuda":
        if launches <= 0:
            raise AssertionError("%s: K1 never launched" % what)
        out.update(sync_check=gr.summary(),
                   recorded=check_recorded(record, what))
    return out


def _rest_chaos_child(url, device="cuda") -> dict:
    """The scheduler side of _chaos_rest, in its own process: a
    RestClusterStore on ``url`` and a gang scheduler under "pallas"
    (batch 1,000, the chain on) armed from KUBETPU_CHAOS, drained until
    nothing is active or backing off; then the watch loop is given until
    its armed faults have fired."""
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.client.rest import RestClusterStore
    from kubetpu_torch.scheduler import Scheduler
    from kubetpu_torch.utils import chaos
    from kubetpu_torch.utils.metrics import SchedulerMetrics
    store = RestClusterStore(url)
    if not store.wait_for_cache_sync(timeout=30.0):
        raise AssertionError("chaos rest: no cache sync")
    metrics = SchedulerMetrics()
    sched = Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=1000, mode="gang",
        kernel_backend="pallas", chain_cycles=True), device=device,
        metrics=metrics)
    reg = chaos.active()
    t0 = time.perf_counter()
    deadline = t0 + 120.0
    bound = 0
    while time.perf_counter() < deadline:
        sched.queue.flush_backoff_completed()
        got = sched.schedule_pending(timeout=0.2)
        bound += sum(1 for o in got if o.node)
        if (not got and not len(sched.queue.active_q)
                and not len(sched.queue.backoff_q)):
            break
    seconds = time.perf_counter() - t0
    while (reg.counts().get("watch", 0) < 2
           and time.perf_counter() < deadline):
        time.sleep(0.05)
    sched._sync_chaos_metrics()
    sched.close()
    store.close()
    fired = reg.counts()
    return dict(fired=fired, bound=bound, seconds=seconds,
                faults_injected={pt: metrics.faults_injected.value(pt)
                                 for pt in fired},
                recoveries=[e["kind"] for e in sched.recovery_log],
                bind_retries=metrics.recoveries.value("bind-retry"),
                routes=sorted({b for b, _ in sched.gang_backends}),
                cycles=sched.cycle_count)


def _chaos_rest(n_nodes=REST_NODES, n_pods=REST_PODS, device="cuda") -> dict:
    """The REST control plane in two processes under injected transport
    faults: this process serves the serving phase's hollow cluster (1,000
    nodes, 2,000 pods) through APIServer on a store that counts binds;
    the second (_rest_chaos_child) schedules it with
    KUBETPU_CHAOS=CHAOS_REST_SPEC: two API-server errors and two watch
    disconnects.  Every armed point fired, every pod bound exactly once
    on the server, no recovery logged, the kernel route kept."""
    import os
    from kubetpu_torch.client.rest import APIServer
    from kubetpu_torch.scheduler import capacity_violations
    src = hollow_store(n_nodes, 0)
    for p in pending_pods(n_pods, "rest"):
        src.add(p)
    store = counting_store(src)
    api = APIServer(store)
    port = api.start()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, KUBETPU_CHAOS=CHAOS_REST_SPEC,
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    try:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-c",
             "import json, chip_smoke; print(json.dumps("
             "chip_smoke._rest_chaos_child(%r, %r)))"
             % ("http://127.0.0.1:%d" % port, device)],
            cwd=root, env=env, capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
    finally:
        api.stop()
    if run.returncode != 0:
        raise AssertionError("chaos rest: the scheduler process exited %d"
                             "\n%s" % (run.returncode, run.stderr[-3000:]))
    child = json.loads(run.stdout.strip().splitlines()[-1])
    what = "chaos rest"
    if child["fired"] != {"rest": 2, "watch": 2} \
            or child["faults_injected"] != child["fired"]:
        raise AssertionError("%s: fired %s, faults_injected %s"
                             % (what, child["fired"],
                                child["faults_injected"]))
    if child["recoveries"] or child["routes"] != ["pallas"]:
        raise AssertionError("%s: recoveries %s, routes %s"
                             % (what, child["recoveries"], child["routes"]))
    bound = sorted(p.metadata.name for p in store.list("Pod")
                   if p.spec.node_name)
    if (len(bound) != n_pods or sorted(store.bind_calls) != bound
            or child["bound"] != n_pods):
        raise AssertionError("%s: %d bound on the server, %d binds, the "
                             "client says %d" % (what, len(bound),
                                                 len(store.bind_calls),
                                                 child["bound"]))
    if capacity_violations(store):
        raise AssertionError("%s: capacity violated" % what)
    return dict(child, process_s=seconds, server_bound=len(bound),
                events=event_counts(store))


def phase_chaos() -> dict:
    """Injected faults on the card, armed through KUBETPU_CHAOS: the
    backlog in process (dispatch, delta, bind) and REST in two processes
    (rest, watch)."""
    backlog = _chaos_backlog()
    # in processes of its own (run beside the earlier phases by main())
    rest, waited = child_result("chaos rest", _chaos_rest_logged)
    return dict(launches=backlog["launches"], backlog=backlog, rest=rest,
                card_wait_s=waited, recorded=backlog["recorded"])


def _chaos_rest_logged() -> dict:
    """_chaos_rest with the port's log watched (LoggedFaults)."""
    with LoggedFaults("chaos rest"):
        return _chaos_rest()


# ---------------------------------------------------------------------------
# volumes

# scheduler_perf's volume workloads (config/performance-config.yaml:27-70)
# and the Workload flag each sets
VOLUME_WORKLOADS = (("SchedulingSecrets", "secrets"),
                    ("SchedulingInTreePVs", "pvs"),
                    ("SchedulingMigratedInTreePVs", "migrated_pvs"),
                    ("SchedulingCSIPVs", "csi_pvs"))
GANG_VOLUME_WORKLOADS = ("SchedulingInTreePVs", "SchedulingCSIPVs")
ATTACH_LIMIT = 39     # the CSINodes' ebs.csi.aws.com limit and EBS's default


def volume_workload(name, flag, n_nodes):
    """The workload's literal values (config/performance-config.yaml:
    27-70): n_nodes nodes and as many init pods, 1,000 measured pods;
    the 5,000-node variant's name and timeout."""
    from kubetpu_torch.harness.perf import Workload
    big = n_nodes == 5000
    return Workload(name=name + ("5000Nodes" if big else ""),
                    num_nodes=n_nodes, num_init_pods=n_nodes,
                    num_pods_to_schedule=1000,
                    timeout_s=900.0 if big else 300.0, **{flag: True})


def volume_workload_world(w):
    """The workload's store (harness/perf.workload_store), its init pods
    bound one per node (the cut the other phases make: the benchmark
    schedules them) and its measured pods, not yet added."""
    from kubetpu_torch.harness.perf import _make_pod, workload_store
    store = workload_store(w)
    for i in range(w.num_init_pods):
        p = _make_pod(w, i, "init", store)
        p.spec.node_name = "node-%d" % (i % w.num_nodes)
        store.add(p)
    return store, [_make_pod(w, i, "measured", store)
                   for i in range(w.num_pods_to_schedule)]


def vol_backlog_world(n_nodes=1000, n_pods=4096):
    """kubetpu_torch/harness/volume_worlds.backlog: the backlog's shape
    with one bound CSI volume per pod, zone-pinned, under CSINode limits.
    (Smaller sizes only for a CPU rehearsal.)"""
    from kubetpu_torch.api import types as api
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.harness import hollow
    from kubetpu_torch.harness import volume_worlds as VW
    w = VW.backlog(api, hollow, n_nodes=n_nodes, n_pods=n_pods)
    store = ClusterStore()
    VW.populate(store, w)
    return store, w.pending


class _QueueClock:
    """The scheduling queue's clock, advanced by volume_drain."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def volume_drain(store, pods, backend, batch_size, device, record=None,
                 record_limit=None, max_cycles=16):
    """Drain ``pods`` in gang mode under ``backend``, or under the default
    configuration with backend None, on a queue clock that passes every
    backoff and the unschedulable leftover timeout before each cycle, so
    a drain on the card and one on the CPU retry the same pods in the
    same cycles (on the wall clock the retries would follow each device's
    speed).  Ends after a cycle that binds nothing.  On the card every
    gang auction runs under GangRounds and every scan under SeqScans.
    Reports the overlay's host seconds and the volume mask's device ms
    (CUDA events) per cycle.  Returns (scheduler, stats)."""
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.scheduler import Scheduler
    from kubetpu_torch.state import volumes as V
    cfg = KubeSchedulerConfiguration(profiles=[KubeSchedulerProfile()],
                                     batch_size=batch_size)
    if backend is not None:
        cfg.mode, cfg.kernel_backend = "gang", backend
    sched = Scheduler(store, config=cfg, device=device)
    clock = _QueueClock()
    sched.queue._clock = clock
    for p in pods:
        store.add(p)
    card = device == "cuda"
    instr = ((GangRounds() if backend is not None else SeqScans()) if card
             else contextlib.nullcontext())
    build, overlay_s = V.build_volume_overlay, []

    def timed_build(*args, **kw):
        t = time.perf_counter()
        out = build(*args, **kw)
        overlay_s.append(time.perf_counter() - t)
        return out
    V.build_volume_overlay = timed_build
    restore = (_record_launches(record, record_limit)
               if record is not None else None)
    try:
        with DeviceTimed(V, "volume_mask") as mask, instr as ins:
            t0 = time.perf_counter()
            for _ in range(max_cycles):
                clock.t += 1000.0
                sched.queue.flush_backoff_completed()
                sched.queue.flush_unschedulable_leftover()
                if not any(o.node for o in sched.schedule_pending()):
                    break
            seconds = time.perf_counter() - t0
    finally:
        V.build_volume_overlay = build
        if restore is not None:
            restore()
    sched.close()
    check_no_recovery(sched, "volume drain %s %s" % (backend or "sequential",
                                                     device))
    if sched.preempt_wave_failures:
        raise AssertionError("volume drain: %d preemption waves failed"
                             % sched.preempt_wave_failures)
    mask_ms = mask.ms()
    stats = dict(cycles=sched.cycle_count, drain_s=seconds,
                 stage_s=dict(sched.stage_s), overlay_host_s=overlay_s,
                 mask_device_ms=mask_ms,
                 resident=resident_report(sched, seconds))
    if backend is not None:
        stats.update(rounds=sched.gang_rounds,
                     routes=sorted(set(sched.gang_backends)))
    if card:
        stats["mask_share_of_auction"] = (
            sum(mask_ms) / (sched.stage_s["auction"] * 1e3))
        stats["sync_check" if backend is not None else "scan"] = \
            ins.summary()
    return sched, stats


def volume_view(store) -> tuple:
    """What a drain left: every pod's node and PodScheduled messages,
    every claim's volume, phase and annotations (the selected-node stamp
    of delayed provisioning)."""
    pods = sorted((p.metadata.name, p.spec.node_name,
                   tuple(c.message for c in p.status.conditions))
                  for p in store.list("Pod"))
    claims = sorted((c.metadata.name, c.volume_name, c.phase,
                     tuple(sorted(c.metadata.annotations.items())))
                    for c in store.list("PersistentVolumeClaim"))
    return pods, claims


def check_volume_drain(store, what, n_bound=None) -> int:
    """n_bound pods bound (when given), no capacity violated, and no node
    holding more distinct volumes of one driver (a CSI driver, or in-tree
    EBS) than its limit: its CSINode's for the driver, else
    ATTACH_LIMIT.  Returns the largest count."""
    from kubetpu_torch.scheduler import capacity_violations
    bound = [p for p in store.list("Pod") if p.spec.node_name]
    if n_bound is not None and len(bound) != n_bound:
        raise AssertionError("%s: %d/%d pods bound"
                             % (what, len(bound), n_bound))
    bad = capacity_violations(store)
    if bad:
        raise AssertionError("%s: capacity violated on %s" % (what, bad[:5]))
    per = {}
    for p in bound:
        for v in p.spec.volumes:
            pvc = (store.get_pvc(p.namespace, v.persistent_volume_claim)
                   if v.persistent_volume_claim else None)
            pv = store.get_pv(pvc.volume_name) if pvc is not None else None
            if pv is None:
                continue
            drv = pv.csi_driver or ("aws-ebs" if pv.aws_elastic_block_store
                                    else None)
            if drv is not None:
                per.setdefault((p.spec.node_name, drv), set()).add(
                    pv.csi_volume_handle or pv.aws_elastic_block_store)
    for (node, drv), vols in per.items():
        csinode = store.get_csinode(node)
        limit = (csinode.driver_allocatable.get(drv, ATTACH_LIMIT)
                 if csinode is not None else ATTACH_LIMIT)
        if len(vols) > limit:
            raise AssertionError("%s: %s attaches %d %s volumes (limit %d)"
                                 % (what, node, len(vols), drv, limit))
    return max((len(x) for x in per.values()), default=0)


def host_volume_verdicts(store, infos, pods):
    """The port's volume plugins, every pod x every node."""
    import numpy as np
    from kubetpu_torch.framework.interface import CycleState
    from kubetpu_torch.plugins import volumes as vplug
    from kubetpu_torch.state import volumes as V
    plugins = [getattr(vplug, n)(store)
               for n in sorted(V.DEVICE_COVERED_PLUGINS)]
    out = np.ones((len(pods), len(infos)), bool)
    for i, pod in enumerate(pods):
        for p in plugins:
            if not p.relevant(pod):
                continue
            for j, ni in enumerate(infos):
                if not p.filter(CycleState(), pod, ni).is_success():
                    out[i, j] = False
    return out


def volume_masks(store, infos, pods):
    """The volume mask of ``pods`` against ``infos`` on the card and on
    the CPU (numpy), and the card's device ms (CUDA events around the
    call, upload of the overlay included)."""
    from kubetpu_torch.framework.types import PodInfo
    from kubetpu_torch.state import volumes as V
    from kubetpu_torch.state.tensors import SnapshotBuilder
    builder = SnapshotBuilder()
    builder.intern_pending([PodInfo(p) for p in pods])
    host = builder.build(infos)
    ov = V.build_volume_overlay(store, infos, pods, builder.table,
                                set(V.DEVICE_COVERED_PLUGINS))
    cluster = host.to_device("cuda")
    with DeviceTimed(V, "volume_mask") as timed:
        on_card = V.volume_mask(cluster, ov).cpu().numpy()
    on_cpu = V.volume_mask(host.to_device("cpu"), ov).numpy()
    return on_card, on_cpu, timed.ms()[0]


def volume_mask_worlds() -> dict:
    """Eight seeded volume worlds (harness/volume_worlds.world, 64 nodes x
    128 pods): the card's mask equals the CPU's bitwise and the host
    plugins' verdicts on every (pod, node)."""
    from kubetpu_torch.api import types as api
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.framework.types import NodeInfo
    from kubetpu_torch.harness import volume_worlds as VW
    seeds, n_nodes, n_pending = range(8), 64, 128
    failing = 0
    for seed in seeds:
        w = VW.world(api, seed, n_nodes=n_nodes, n_pending=n_pending,
                     n_pvs=n_nodes, max_existing=3)
        store = ClusterStore()
        VW.populate(store, w)
        infos = VW.node_infos(NodeInfo, w)
        on_card, on_cpu, _ = volume_masks(store, infos, w.pending)
        if not (on_card == on_cpu).all():
            raise AssertionError("volumes: seed %d: the card's mask differs "
                                 "from the CPU's" % seed)
        want = host_volume_verdicts(store, infos, w.pending)
        if not (on_card[:len(w.pending), :n_nodes] == want).all():
            raise AssertionError("volumes: seed %d: the mask differs from "
                                 "the host plugins" % seed)
        failing += int((~want).sum())
    return dict(worlds=len(seeds), nodes=n_nodes, pods=n_pending,
                failing_pairs=failing, matches_cpu=True,
                matches_host_plugins=True)


def _volume_world_drain(what, world, backend, batch_size, n_bound) -> dict:
    """``world`` = (fn, args), a world's builder, drained on the CPU: the
    view (placements, claims, failure messages) and the drain's stats."""
    fn, args = world
    store, pods = fn(*args)
    _, stats = volume_drain(store, pods, backend, batch_size, "cpu")
    stats["max_attach"] = check_volume_drain(store, what, n_bound)
    return dict(view=volume_view(store), stats=stats)


def _volume_card_vs_cpu(what, world, backend, batch_size, n_bound,
                        record_limit=None):
    """One world (``world`` = (fn, args), its builder) drained on the
    card (K1's launches counted from zero, and recorded when
    record_limit is set) and on the CPU (main()'s reference child): the
    same placements, claims and failure messages.  n_bound: the pods
    each drain must leave bound (None: any number)."""
    from kubetpu_torch.ops import propose as PK
    record = [] if record_limit is not None else None
    fn, args = world
    store, pods = fn(*args)
    PK.propose.launches = 0      # this path starts: zero the count
    _, stats = volume_drain(store, pods, backend, batch_size, "cuda",
                            record, record_limit)
    stats["launches"] = PK.propose.launches
    stats["max_attach"] = check_volume_drain(store, what, n_bound)
    card_view = volume_view(store)
    cpu, waited = child_result(what, _volume_world_drain, what, world,
                               backend, batch_size, n_bound)
    if card_view != cpu["view"]:
        diff = sum(1 for a, b in zip(card_view[0], cpu["view"][0])
                   if a != b)
        raise AssertionError("%s: card and CPU differ (%d pods; claims "
                             "equal: %s)" % (what, diff,
                                             card_view[1] ==
                                             cpu["view"][1]))
    out = dict(stats, cpu_drain_s=cpu["stats"]["drain_s"],
               cpu_stage_s=cpu["stats"]["stage_s"], cpu_wait_s=waited,
               matches_cpu=True)
    if record is not None:
        if out["launches"] <= 0:
            raise AssertionError("%s: the propose kernel never launched"
                                 % what)
        out["recorded"] = check_recorded(record, what)
    return out


def _volume_refs():
    """The volumes phase's card-vs-CPU drains, (what, world, backend,
    batch size, pods bound): scheduler_perf's four volume workloads at
    500 nodes (sequential, and gang under "pallas" for the PV and CSI
    ones), and vol_backlog."""
    refs = []
    for name, flag in VOLUME_WORKLOADS:
        w = volume_workload(name, flag, 500)
        for backend in ((None, "pallas") if name in GANG_VOLUME_WORKLOADS
                        else (None,)):
            refs.append(("%s %s" % (w.name, backend or "sequential"),
                         (volume_workload_world, (w,)), backend,
                         1000 if backend else 256,
                         w.num_init_pods + w.num_pods_to_schedule))
    refs.append(("vol_backlog", (vol_backlog_world, ()), "pallas", 4096,
                 None))
    return refs


def phase_volumes() -> dict:
    """The volume family: seeded masks card = CPU = host plugins;
    scheduler_perf's four volume workloads at 500 nodes, card = CPU
    (sequential, and gang under "pallas" for the PV and CSI ones);
    vol_backlog card = CPU with K1 launched through the volume mask;
    the four workloads at 5,000 nodes on the card in both modes, each
    with the mask of 8 sampled pods held to the host plugins on every
    node."""
    import copy
    from kubetpu_torch.ops import propose as PK
    out = {"launches": 0, "mask_worlds": volume_mask_worlds()}
    for what, world, backend, batch_size, n_bound in _volume_refs():
        res = _volume_card_vs_cpu(
            what, world, backend, batch_size, n_bound,
            record_limit=16 if what == "vol_backlog" else None)
        out["launches"] += res["launches"]
        out[what] = res

    for name, flag in VOLUME_WORKLOADS:
        w = volume_workload(name, flag, 5000)
        for backend in (None, "pallas"):
            what = "%s %s" % (w.name, backend or "sequential")
            store, pods = volume_workload_world(w)
            PK.propose.launches = 0      # this path starts: zero the count
            _, stats = volume_drain(store, pods, backend, 1000, "cuda")
            stats["launches"] = PK.propose.launches
            out["launches"] += stats["launches"]
            stats["max_attach"] = check_volume_drain(
                store, what, w.num_init_pods + w.num_pods_to_schedule)
            if backend is None:
                # 8 sampled pods, as pending copies, against the drained
                # cluster, every node
                sample = [copy.deepcopy(p)
                          for p in pods[::len(pods) // 8][:8]]
                for p in sample:
                    p.spec.node_name = ""
                infos = node_infos_of(store)
                on_card, on_cpu, ms = volume_masks(store, infos, sample)
                want = host_volume_verdicts(store, infos, sample)
                if not ((on_card == on_cpu).all() and
                        (on_card[:8, :len(infos)] == want).all()):
                    raise AssertionError("%s: the sampled mask differs"
                                         % what)
                stats["sampled_mask"] = dict(pods=8, nodes=len(infos),
                                             feasible=int(want.sum()),
                                             ms=ms)
            out[what] = stats
    return out


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _device_rows(prof):
    """Device kernels only, by device time: an operator's row also carries
    the device time of the kernels it launched, so summing every row
    counts it twice."""
    import torch
    return sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=_dev_us, reverse=True)


def _top(rows):
    return [[e.key[:60], e.count, _dev_us(e) / 1e3]
            for e in rows[:8] if _dev_us(e) > 0]


def _profiled_drain(store, pods, backend, batch_size):
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched, placed, _, _ = drain(store, pods, backend, batch_size,
                                    "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    busy_ms = sum(_dev_us(e) for e in rows) / 1e3
    return dict(wall_s=wall, device_busy_ms=busy_ms,
                device_idle_share=(1.0 - busy_ms / 1e3 / wall
                                   if busy_ms > 0 else None),
                top=_top(rows),
                placed=sum(1 for v in placed.values() if v))


def _profiled_scan_window(store, pods, first=256, steps=128,
                          sched_profile=None):
    """The seq_slice drain with torch.profiler on over a steady window of
    its scan (steps first .. first+steps-1; the whole scan's ~500k
    launches would take the profiler minutes to parse), its pods cut to
    the window's end (the steps after it are not read): device busy time
    and idle share of the window, top kernels, kernel launches per step
    (the host's CUDA launch calls, and the device kernels), the gemv
    kernels' share of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from kubetpu_torch.models import sequential as S
    pods = pods[:first + steps]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}
    orig_scan = S._scan

    def scan(step, B):
        # models/sequential._scan, with the profiler on over the window
        outs = []
        for i in range(B):
            if i == first:
                torch.cuda.synchronize()
                prof.start()
                window["t0"] = time.perf_counter()
            outs.append(step(i))
            if i == first + steps - 1:
                torch.cuda.synchronize()
                window["wall"] = time.perf_counter() - window["t0"]
                prof.stop()
        return [torch.stack(col) for col in zip(*outs)]
    S._scan = scan
    try:
        _, placed, _, _ = drain(store, pods, None, 1000, "cuda",
                                profile=sched_profile)
    finally:
        S._scan = orig_scan
    rows = _device_rows(prof)
    busy_ms = sum(_dev_us(e) for e in rows) / 1e3
    launches = sum(1 for e in prof.events() if "LaunchKernel" in e.name)
    gemv_ms = sum(_dev_us(e) for e in rows if "gemv" in e.key) / 1e3
    wall = window["wall"]
    return dict(window_steps=steps, first_step=first, wall_s=wall,
                wall_ms_per_step=wall / steps * 1e3,
                device_busy_ms=busy_ms,
                device_ms_per_step=busy_ms / steps,
                device_idle_share=(1.0 - busy_ms / 1e3 / wall
                                   if busy_ms > 0 else None),
                top=_top(rows), launches_per_step=launches / steps,
                device_kernels_per_step=sum(e.count for e in rows) / steps,
                gemv_device_ms=gemv_ms,
                gemv_share_of_busy=gemv_ms / busy_ms if busy_ms else None,
                placed=sum(1 for v in placed.values() if v))


def _profiled_rounds_window(store, pods, first=40, n=16):
    """A gang drain with torch.profiler on over a steady window of its
    auction rounds (rounds first .. first+n-1, counted by flag reads,
    across cycles): device busy time and idle share of the window, top
    kernels, kernel launches per round (the host's CUDA launch calls, and
    the device kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from kubetpu_torch.models import gang as G
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = dict(reads=0)
    orig_read = G._read_flags

    def read_flags(flags):
        # runs with the sync debug mode off (GangRounds allows this read)
        out = orig_read(flags)
        window["reads"] += 1
        if window["reads"] == first:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        elif window["reads"] == first + n:
            torch.cuda.synchronize()
            window["wall"] = time.perf_counter() - window["t0"]
            prof.stop()
        return out
    G._read_flags = read_flags
    try:
        _, placed, _, _ = drain(store, pods, "pallas", 1000, "cuda")
    finally:
        G._read_flags = orig_read
    if "wall" not in window:
        raise AssertionError("profile: the drain ran %d rounds, fewer than "
                             "the window's end %d" % (window["reads"],
                                                      first + n))
    rows = _device_rows(prof)
    busy_ms = sum(_dev_us(e) for e in rows) / 1e3
    launches = sum(1 for e in prof.events() if "LaunchKernel" in e.name)
    wall = window["wall"]
    return dict(window_rounds=n, first_round=first, wall_s=wall,
                wall_ms_per_round=wall / n * 1e3, device_busy_ms=busy_ms,
                device_ms_per_round=busy_ms / n,
                device_idle_share=(1.0 - busy_ms / 1e3 / wall
                                   if busy_ms > 0 else None),
                top=_top(rows), launches_per_round=launches / n,
                device_kernels_per_round=sum(e.count for e in rows) / n,
                placed=sum(1 for v in placed.values() if v))


def _profiled_audit(n_nodes=FILL_NODES, n_pods=1000):
    """One decision audit under torch.profiler: the first cycle of the
    packed fill with ``n_pods`` preemptors (gang, pallas, one batch; every
    row fails, so the cycle runs the wave and then the audit), with the
    profiler on over its explain_verdicts call alone.  Reports the call's
    host dispatch time (until it returns), its stream time (CUDA events
    around it), the wall time until the device is done, the kernels' busy
    time and idle share of the stream time, the host's launch calls and
    the device kernels, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from kubetpu_torch.models import programs as PR
    store = packed_fill_store(n_nodes)
    orig = PR.explain_verdicts
    got = {}

    def explain(cluster, *args, **kw):
        if got:
            return orig(cluster, *args, **kw)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            out = orig(cluster, *args, **kw)
            b.record()
            got["host_ms"] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            got["wall_ms"] = (time.perf_counter() - t0) * 1e3
        got["stream_ms"] = a.elapsed_time(b)
        got["prof"] = prof
        return out
    PR.explain_verdicts = explain
    try:
        _preempt_drain(store, preemptor_pods(n_pods), "pallas", "cuda",
                       n_pods, max_cycles=1)
    finally:
        PR.explain_verdicts = orig
    if "prof" not in got:
        raise AssertionError("profile audit: the cycle ran no audit")
    prof = got.pop("prof")
    rows = _device_rows(prof)
    busy_ms = sum(_dev_us(e) for e in rows) / 1e3
    return dict(got, device_busy_ms=busy_ms,
                idle_share_of_stream=1.0 - busy_ms / got["stream_ms"],
                launches=sum(1 for e in prof.events()
                             if "LaunchKernel" in e.name),
                device_kernels=sum(e.count for e in rows), top=_top(rows))


# ---------------------------------------------------------------------------
# measure: scheduler_perf's runner and the recorders


MEASURE_SUSTAINED = dict(rate=200.0, duration_s=20.0, seed=11,
                         mean_dwell_s=10.0)


def _arm_recorders(arm, flight_capacity=64, window_s=2.0):
    """Arm (fresh) or disarm the flight recorder, the SLO tracker and the
    load-telemetry ring together."""
    from kubetpu_torch.utils import slo, telemetry, trace
    trace.disarm_flight_recorder()
    slo.disarm_slo_tracker()
    telemetry.disarm_telemetry()
    if arm:
        trace.arm_flight_recorder(capacity=flight_capacity)
        slo.arm_slo_tracker()
        telemetry.arm_telemetry(window_s=window_s)


def _start_perf_cli(name="SchedulingBasic5000Nodes",
                    config="config/performance-config.yaml", device="cuda"):
    """Start ``python -m kubetpu_torch.harness.perf --config
    config/performance-config.yaml --only SchedulingBasic5000Nodes`` as a
    child process on the card (5,000 nodes, 5,000 init pods, 1,000
    measured pods; no cut), its output to files in a temporary directory
    of the checkout.  (Another workload, YAML and device only for a CPU
    rehearsal.)"""
    import os
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    tmp = tempfile.TemporaryDirectory(dir=root)
    out = os.path.join(tmp.name, "perf.json")
    with open(os.path.join(tmp.name, "stdout"), "w") as so, \
            open(os.path.join(tmp.name, "stderr"), "w") as se:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubetpu_torch.harness.perf", "--config",
             os.path.join(root, config), "--only", name, "--out", out,
             "--verbose", "--device", device],
            cwd=root, env=env, stdout=so, stderr=se)
    return dict(proc=proc, tmp=tmp, out=out, name=name,
                config=os.path.join(root, config), t0=time.time())


def _finish_perf_cli(cli, timeout_s=600):
    """Wait for the perf CLI: exit 0, no Incomplete or Error label on its
    SchedulingThroughput, every measured pod bound (its verbose line); its
    pods/s, SchedulerStats and the four latency histograms reported."""
    import os
    from kubetpu_torch.harness.perf import load_workloads
    proc, tmp, name = cli["proc"], cli["tmp"], cli["name"]
    try:
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise
        with open(os.path.join(tmp.name, "stdout")) as fh:
            stdout = fh.read()
        with open(os.path.join(tmp.name, "stderr")) as fh:
            stderr = fh.read()
        if rc != 0:
            raise AssertionError("perf CLI: exit %d\n%s"
                                 % (rc, stderr[-3000:]))
        faults = [ln for ln in stderr.splitlines()
                  if any(f in ln for f in PORT_FAULT_LINES)]
        if faults:
            raise AssertionError("perf CLI: the port logged faults:\n%s"
                                 % stderr[-3000:])
        with open(cli["out"]) as fh:
            doc = json.load(fh)
        # start to the last write of --out (just before the child exits)
        seconds = os.path.getmtime(cli["out"]) - cli["t0"]
    finally:
        tmp.cleanup()
    items = {it["labels"]["Metric"]: it for it in doc["dataItems"]
             if it["labels"]["Name"] == name}
    tp = items["SchedulingThroughput"]
    if set(tp["labels"]) != {"Name", "Metric"}:
        raise AssertionError("perf CLI: %s" % tp["labels"])
    n = [w.num_pods_to_schedule for w in load_workloads(cli["config"])
         if w.name == name][0]
    if "  %s: %d/%d scheduled" % (name, n, n) not in stdout.splitlines():
        raise AssertionError("perf CLI: not every measured pod bound:\n%s"
                             % stdout[:2000])
    return dict(process_s=seconds, pods_per_s=tp["data"],
                scheduler_stats=items["SchedulerStats"]["data"],
                latency_s={m: items[m]["data"] for m in (
                    "scheduling_algorithm_duration_seconds",
                    "binding_duration_seconds",
                    "e2e_scheduling_duration_seconds",
                    "pod_scheduling_duration_seconds")})


def _measure_preemption(device="cuda", name="Preemption",
                        config="config/performance-config.yaml",
                        flight_capacity=8):
    """scheduler_perf's Preemption (500 nodes, 2,000 low-priority fillers,
    500 preemptors of 600m) through run_workload in this process on the
    card, the three recorders armed (the flight ring at 8 cycles, so it
    sheds): the FlightRecorder item's cycles are the ring's, and its
    cycles plus its drops every record committed; every pod bound or
    evicted, every evicted pod a filler deleted once, no capacity
    overcommitted, no recovery, no demotion."""
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.harness import perf as P
    from kubetpu_torch.scheduler import Scheduler, capacity_violations
    from kubetpu_torch.utils import slo, telemetry, trace
    w = [x for x in P.load_workloads(config) if x.name == name][0]
    made, deleted, committed = [], {}, [0]
    orig_delete = ClusterStore.delete
    orig_commit = trace.FlightRecorder.commit_cycle

    class Captured(Scheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def delete(store, obj, *a, **kw):
        if getattr(obj, "kind", "") == "Pod":
            key = obj.metadata.name
            deleted[key] = deleted.get(key, 0) + 1
        return orig_delete(store, obj, *a, **kw)

    def commit(fr, rec):
        committed[0] += 1
        return orig_commit(fr, rec)

    _arm_recorders(True, flight_capacity=flight_capacity)
    P.Scheduler, ClusterStore.delete = Captured, delete
    trace.FlightRecorder.commit_cycle = commit
    t0 = time.perf_counter()
    try:
        with LoggedFaults("preemption"):
            items = P.run_workload(w, device=device)
        fr = trace.flight_recorder()
        held, dropped = len(fr.cycles()), fr.dropped()
        slo_doc = slo.tracker().to_dict()
        load = telemetry.ring().digest()
    finally:
        P.Scheduler, ClusterStore.delete = Scheduler, orig_delete
        trace.FlightRecorder.commit_cycle = orig_commit
        _arm_recorders(False)
    seconds = time.perf_counter() - t0
    by = {it.labels["Metric"]: it for it in items}
    if set(by["SchedulingThroughput"].labels) != {"Name", "Metric"}:
        raise AssertionError("preemption: %s"
                             % by["SchedulingThroughput"].labels)
    rec = by["FlightRecorder"].data
    if not (rec["Cycles"] == held
            and rec["Cycles"] + rec["Dropped"] == committed[0]
            and rec["Dropped"] == dropped > 0):
        raise AssertionError("preemption: FlightRecorder %s, the ring held "
                             "%d and dropped %d of %d records"
                             % (rec, held, dropped, committed[0]))
    (sched,) = made
    store = sched.store
    pods = {p.metadata.name: p for p in store.list("Pod")}
    lost = [n for n in ["init-%d" % i for i in range(w.num_init_pods)]
            + ["measured-%d" % i for i in range(w.num_pods_to_schedule)]
            if not (n in pods and pods[n].spec.node_name) and n not in deleted]
    twice = [n for n, k in deleted.items() if k > 1]
    not_filler = [n for n in deleted if not n.startswith("init-")]
    if lost or twice or not_filler or capacity_violations(store):
        raise AssertionError("preemption: lost %s, deleted twice %s, "
                             "evicted non-fillers %s, capacity %s"
                             % (lost[:5], twice[:5], not_filler[:5],
                                capacity_violations(store)[:5]))
    check_no_recovery(sched, "preemption")
    return dict(seconds=seconds, evictions=len(deleted),
                pods_per_s=by["SchedulingThroughput"].data,
                scheduler_stats=by["SchedulerStats"].data,
                flight_recorder=rec, committed_records=committed[0],
                slo_pods=slo_doc["pods"],
                slo_e2e_s=slo_doc["stages"]["e2e"],
                slo_shares=slo_doc["shares"], load_windows=load["windows"])


def _measure_sustained(n_nodes=5000, device="cuda", stream=None):
    """SustainedLoadRunner on 5,000 hollow nodes: poisson_stream(200
    pods/s, 20 s, seed 11, mean dwell 10 s) fired open-loop at a serving
    scheduler (gang under "pallas", batch 256, the pool binder), the SLO
    tracker and a 2 s telemetry window armed.  The stream's departures
    that fall after its 20 s window are not fired (a cut: with them the
    injector would run ~70 s).  Gates on correctness only: every offered
    pod bound, departed or pending, none bound twice, completed_frac >=
    0.95, no recovery, no demotion, nothing the port logged as a fault
    (the serving loop logs a cycle that raised and goes on); on the card
    K1 launched, and every launch recorded and held to the plain
    version."""
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.harness import hollow
    from kubetpu_torch.harness.perf import SustainedLoadRunner
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.scheduler import Scheduler, capacity_violations
    from kubetpu_torch.utils import telemetry
    from kubetpu_torch.utils.trace import wallclock
    kw = stream or MEASURE_SUSTAINED
    events = [e for e in hollow.poisson_stream(**kw)
              if e["t"] < kw["duration_s"]]
    store = hollow_store(n_nodes, 0)
    binds = {}

    def on_pod(event, old, new):
        if (event == "update" and new.spec.node_name
                and not old.spec.node_name):
            binds[new.metadata.name] = binds.get(new.metadata.name, 0) + 1
    store.subscribe("Pod", on_pod)
    _arm_recorders(True)
    with LoggedFaults("sustained"):
        sched = Scheduler(store, config=KubeSchedulerConfiguration(
            profiles=[KubeSchedulerProfile()], batch_size=256, mode="gang",
            kernel_backend="pallas"), device=device, async_binding=True)
        record, restore = [], None
        try:
            sched.run()
            restore = _record_launches(record, None)
            PK.propose.launches = 0      # this path starts: zero the count
            t_inject = wallclock()
            res = SustainedLoadRunner(store, sched, events, kw["duration_s"],
                                      settle_s=30.0).run()
            launches = PK.propose.launches
            ring = telemetry.ring()
            windows = ring.windows()
            # the slope test over the windows opened while the stream was
            # injecting (the ring's own verdict also sees the settle's empty
            # windows, which form a flat all-zero tail)
            k = sum(1 for w in windows
                    if w["t0"] < t_inject + kw["duration_s"])
            p99s = ring.e2e_p99_series()[:k]
            span = telemetry.steady_state_span(p99s)
            injecting = dict(windows=k, steady=None)
            if span is not None:
                injecting["steady"] = dict(
                    start=span[0], windows=span[1],
                    p99_s=ring.steady_quantile(*span, 0.99),
                    p50_s=ring.steady_quantile(*span, 0.5))
        finally:
            sched.close()
            if restore is not None:
                restore()
            _arm_recorders(False)
    recorded = None
    if device == "cuda":
        if not launches or len(record) != launches:
            raise AssertionError("sustained: %d K1 launches, %d recorded"
                                 % (launches, len(record)))
        recorded = check_recorded(record, "measure sustained")
    added = [e["pod"].metadata.name for e in events if e["kind"] == "add"]
    departed = {e["pod"].metadata.name for e in events
                if e["kind"] == "delete"}
    pods = {p.metadata.name: p for p in store.list("Pod")}
    lost = [n for n in added if n not in pods and n not in departed]
    twice = [n for n, k in binds.items() if k > 1]
    if lost or twice or capacity_violations(store):
        raise AssertionError("sustained: lost %s, bound twice %s"
                             % (lost[:5], twice[:5]))
    if res["completed_frac"] < 0.95:
        raise AssertionError("sustained: completed_frac %s" % res)
    check_no_recovery(sched, "sustained")
    load = res["load"]
    if load.get("demotions", 0):
        raise AssertionError("sustained: demotions %s" % load)
    steady = load.get("steady") or {}
    return dict(offered=res["offered"], offered_rate=res["offered_rate"],
                completed=res["completed"],
                completed_rate=res["completed_rate"],
                completed_frac=res["completed_frac"],
                departures=res["deletes"],
                behind_max_s=res["behind_max_s"],
                pending=sum(1 for n in added
                            if n in pods and not pods[n].spec.node_name),
                steady_windows=steady.get("windows"),
                steady_e2e_p99_s=steady.get("p99_s"),
                steady_e2e_p50_s=steady.get("p50_s"),
                injecting=injecting,
                windows=load["windows"], worst_window=load["worst_window"],
                cycles=sched.cycle_count, launches=launches,
                recorded=recorded,
                routes=sorted({b for b, _ in sched.gang_backends}),
                window_e2e_p99_s=p99s)


def _measure_parity(device="cuda", world=None):
    """The backlog's world (1,000 nodes x 4,096 pods) drained under
    "pallas" twice, disarmed and then armed (the flight recorder, the SLO
    tracker and the telemetry ring): the same placements and K1 launch
    counts both times, every launch recorded and
    held to the plain version, every auction under GangRounds (sync debug
    mode "error"); armed, /debug/flightz?format=chrome parses with one
    root span per cycle."""
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.server import SchedulerServer
    runs = []
    for armed in (False, True):
        _arm_recorders(armed)
        record = []
        try:
            store, pods = (world or backlog_world)()
            PK.propose.launches = 0      # this path starts: zero the count
            sched, placed, seconds, rounds = drain(
                store, pods, "pallas", 4096, device, record=record)
            launches = PK.propose.launches
            run = dict(armed=armed, placed=placed, launches=launches,
                       seconds=seconds, rounds=rounds,
                       cycles=sched.cycle_count,
                       recorded=check_recorded(record, "measure parity"))
            if armed:
                server = SchedulerServer(sched, port=0)
                port = server.start()
                try:
                    code, body = _http_get(port,
                                           "/debug/flightz?format=chrome")
                finally:
                    server.stop()
                doc = json.loads(body)
                roots = [e for e in doc["traceEvents"]
                         if e["ph"] == "X" and e["name"] == "Scheduling"]
                if (code != 200 or len(roots) != sched.cycle_count
                        or any(e["args"]["parent_id"] for e in roots)):
                    raise AssertionError(
                        "parity: flightz %d, %d root spans for %d cycles"
                        % (code, len(roots), sched.cycle_count))
                run["chrome_events"] = len(doc["traceEvents"])
        finally:
            _arm_recorders(False)
        runs.append(run)
    first = runs[0]
    for r in runs[1:]:
        if (r["placed"] != first["placed"]
                or r["launches"] != first["launches"]):
            raise AssertionError("parity: armed and disarmed drains differ "
                                 "(%d vs %d launches)"
                                 % (r["launches"], first["launches"]))
    for r in runs:
        r.pop("placed")
    return runs


def phase_measure() -> dict:
    """scheduler_perf's runner and the recorders on the card, one run
    after another (none shares the host or the card with another):
    Preemption through run_workload with the recorders armed, the
    armed-vs-disarmed parity drains, the open-loop sustained run (whose
    settle waits out its 30 s for the pods that departed unbound), then
    the perf CLI on SchedulingBasic5000Nodes in a child process.  K1's
    main path here: the parity drains and the sustained run."""
    import torch
    stamps = {}
    t = time.perf_counter()
    preemption = _measure_preemption()
    stamps["preemption_s"] = time.perf_counter() - t
    t = time.perf_counter()
    parity = _measure_parity()
    stamps["parity_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sustained = _measure_sustained()
    stamps["sustained_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cli = _finish_perf_cli(_start_perf_cli())
    stamps["cli_s"] = time.perf_counter() - t
    recorded = [r["recorded"] for r in parity] + [sustained["recorded"]]
    return dict(launches=(sustained["launches"]
                          + sum(r["launches"] for r in parity)),
                cli=cli, preemption=preemption, sustained=sustained,
                parity=parity, stamps=stamps,
                recorded=dict(checked=sum(r["checked"] for r in recorded),
                              max_abs_err=max(r["max_abs_err"]
                                              for r in recorded),
                              real_launch=recorded[0]["real_launch"]))


# records of the journal's first anchor window, replayed on the CPU too;
# the journal chaos point is armed once they are on disk, so the record
# after them is the truncated one
JOURNAL_WINDOW = 3
# the directory of the copied window while the reference child replays it
JOURNAL_CPU: dict = {}


def _journal_cpu_replay(journal_dir) -> dict:
    """(the reference child) the journal's first anchor window, copied to
    ``journal_dir``, replayed on the CPU: the report's counts and the
    seconds."""
    from kubetpu_torch.kubereplay import replay_journal
    t0 = time.perf_counter()
    rep = replay_journal(journal_dir, device="cpu")
    return dict(seconds=time.perf_counter() - t0,
                **{k: rep[k] for k in ("considered", "replayed", "matched",
                                       "skipped", "bit_match")})


def _start_journal_cpu(jdir) -> None:
    """Copy the first JOURNAL_WINDOW records of the journal and hand their
    CPU replay to the reference child, where it runs beside the later
    phases (journal_cpu_check collects it)."""
    import shutil
    import tempfile
    from kubetpu_torch.utils.journal import record_filename
    wdir = tempfile.mkdtemp(prefix="kubetpu-journal-window-")
    for seq in range(1, JOURNAL_WINDOW + 1):
        shutil.copy(os.path.join(jdir, record_filename(seq)), wdir)
    JOURNAL_CPU["dir"] = wdir
    if "cpu" in POOLS:
        CHILD_JOBS["journal cpu"] = POOLS["cpu"].submit(
            _journal_cpu_replay, wdir)


def journal_cpu_check() -> dict:
    """The journal's first anchor window, replayed on the CPU: every
    record bit-matches the card's."""
    import shutil
    wdir = JOURNAL_CPU.pop("dir")
    try:
        cpu, waited = child_result("journal cpu", _journal_cpu_replay, wdir)
    finally:
        shutil.rmtree(wdir, ignore_errors=True)
    if not (cpu["bit_match"] and cpu["replayed"] == cpu["matched"]
            == JOURNAL_WINDOW):
        raise AssertionError("journal: the CPU replay of the first anchor "
                             "window: %s" % cpu)
    return dict(cpu, waited_s=waited)


class UploadProbe:
    """Each full upload of a DeltaTensorizer (state/delta.py _upload):
    torch.cuda.memory_allocated's rise across it (synchronized) and the
    residency ledger's bytes for the resident just after it."""

    def __init__(self, ds):
        self.ds, self.uploads = ds, []

    def __enter__(self):
        import torch
        from kubetpu_torch.state import delta as D
        self._orig = D.DeltaTensorizer._upload
        orig, probe = self._orig, self

        def upload(tz):
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
            freed = tz.cluster is not None
            orig(tz)
            torch.cuda.synchronize()
            ent = probe.ds.ledger()["entries"].get(
                "delta-resident/" + (tz.profile or "default"), {})
            probe.uploads.append(dict(
                allocated_rise=torch.cuda.memory_allocated() - m0,
                ledger_bytes=ent.get("bytes"), replaced=freed))
        D.DeltaTensorizer._upload = upload
        return self

    def __exit__(self, *exc):
        from kubetpu_torch.state import delta as D
        D.DeltaTensorizer._upload = self._orig


def phase_journal() -> dict:
    """The cycle journal and devstats on the fill (Preemption5000Nodes'
    init phase: 5,000 nodes, 20,000 fillers, gang under "pallas", batch
    1,000, the chain on, pipelined at depth 2), armed: the journal,
    devstats at sample interval 1, and the chaos point journal:truncate
    once the first JOURNAL_WINDOW records are on disk.  The placements
    equal the fill phase's disarmed drain.  Then the whole journal
    replays on the card (python -m kubetpu_torch.kubereplay's
    replay_journal), every K1 launch recorded and held bitwise to the
    plain version: every record bit-matches but the truncated one and
    the broken lineage after it up to the next resync anchor; and the
    first anchor window replays on the CPU in the reference child, beside
    the later phases (main() collects it; journal_cpu_check).  Reports
    per-program device time (CUDA event pairs), fence_wait_s,
    run_auction's roofline fraction against 67e12 f32 FLOP/s (below
    1.05), and the ledger's resident bytes against memory_allocated's
    rise at each upload."""
    import shutil
    import tempfile
    import torch
    from kubetpu_torch.kubereplay import replay_journal
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.utils import chaos as uchaos
    from kubetpu_torch.utils import devstats as ud
    from kubetpu_torch.utils import journal as uj
    from kubetpu_torch.utils.flops import peak_flops_per_s
    out = {}
    if "placements" not in FILL_PALLAS:
        # run without the fill phase: its disarmed pallas drain here
        store, pods = fill_world()
        drain(store, pods, "pallas", 1000, "cuda")
        FILL_PALLAS.update(placements=placements_of(store))
    jdir = tempfile.mkdtemp(prefix="kubetpu-journal-")
    try:
        jr = uj.arm_journal(jdir)
        ds = ud.arm_devstats(sample_interval=1)
        append = jr.append

        def arm_then_append(record):
            if jr.records_total == JOURNAL_WINDOW and uchaos.active() is None:
                uchaos.arm(uchaos.parse_spec("journal:truncate:n=1"))
            return append(record)
        jr.append = arm_then_append
        store, pods = fill_world()
        PK.propose.launches = 0      # this path starts: zero the count
        with UploadProbe(ds) as probe:
            sched, _outs, stats = serve_drain(store, pods, 1000, 2)
        launches = PK.propose.launches
        doc = ds.to_dict()
        out.update(journal=jr.status(), chaos=uchaos.active().counts())
    finally:
        uchaos.disarm()
        uj.disarm_journal()
        ud.disarm_devstats()
    try:
        if placements_of(store) != FILL_PALLAS["placements"]:
            raise AssertionError("journal: the armed drain's placements "
                                 "differ from the fill's disarmed drain")
        if launches <= 0:
            raise AssertionError("journal: the armed drain never launched "
                                 "the propose kernel")
        if out["chaos"].get("journal") != 1 or \
                out["journal"]["records"] != sched.cycle_count:
            raise AssertionError("journal: %d records of %d cycles, chaos "
                                 "%s" % (out["journal"]["records"],
                                         sched.cycle_count, out["chaos"]))
        progs = {name: dict(count=d["count"],
                            device_time_s=d["device_time_s"],
                            mean_s=d["mean_s"], sources=d["sources"],
                            roofline=d.get("roofline"))
                 for name, d in doc["programs"].items()}
        ra = progs["run_auction"]
        if not ra["device_time_s"] > 0 or ra["count"] < sched.cycle_count:
            raise AssertionError("journal: run_auction timed %d times in "
                                 "%d cycles, %r s" % (ra["count"],
                                                   sched.cycle_count,
                                                   ra["device_time_s"]))
        frac = ra["roofline"]["roofline_fraction"]
        if not 0 < frac < 1.05:
            raise AssertionError("journal: run_auction roofline fraction "
                                 "%r" % frac)
        first = probe.uploads[0]
        out.update(launches=launches, drain=stats, cycles=sched.cycle_count,
                   placements_match_fill=True, programs=progs,
                   fence_wait_s=doc["fence_wait_s"],
                   fenced_cycles=doc["fenced_cycles"],
                   peak_f32_flops=peak_flops_per_s(),
                   ledger_bytes=doc["ledger"]["total_bytes"],
                   uploads=probe.uploads,
                   first_upload_ratio=(first["ledger_bytes"]
                                       / first["allocated_rise"]))
        # the whole journal replayed on the card, every K1 launch recorded
        record = []
        restore = _record_launches(record, None)
        PK.propose.launches = 0
        t0 = time.perf_counter()
        try:
            rep = replay_journal(jdir, device="cuda")
        finally:
            restore()
        replay_s = time.perf_counter() - t0
        replay_launches = PK.propose.launches
        kinds = {seq: r["input"] for seq, r, _w in uj.read_records(jdir)
                 if r is not None}
        skipped = [s["seq"] for s in rep["skipped"]]
        cut = JOURNAL_WINDOW + 1
        anchor = min([seq for seq, k in kinds.items()
                      if seq > cut and k == "resync"]
                     or [rep["records"] + 1])
        if (skipped != list(range(cut, anchor))
                or "truncated" not in rep["skipped"][0]["reason"]
                or any("broken-lineage" not in s["reason"]
                       for s in rep["skipped"][1:])):
            raise AssertionError("journal replay: skips %s (truncated "
                                 "record %d, next anchor %d)"
                                 % (rep["skipped"], cut, anchor))
        if not (rep["bit_match"] and rep["matched"] == rep["replayed"]
                == rep["records"] - len(skipped)):
            raise AssertionError("journal replay: %d of %d replayed "
                                 "records bit-matched, first divergence "
                                 "%s" % (rep["matched"], rep["replayed"],
                                         rep["first_divergence"]))
        if replay_launches <= 0:
            raise AssertionError("journal replay: the propose kernel never "
                                 "launched")
        out.update(replay=dict(records=rep["records"],
                               replayed=rep["replayed"],
                               matched=rep["matched"], skipped=skipped,
                               next_anchor=anchor, seconds=replay_s,
                               kinds=sorted(set(kinds.values()))),
                   replay_launches=replay_launches,
                   recorded=check_recorded(record, "journal replay"))
        del record
        torch.cuda.empty_cache()
        _start_journal_cpu(jdir)
        return out
    finally:
        shutil.rmtree(jdir, ignore_errors=True)


def phase_profile() -> dict:
    parts = dict(
        slice=lambda: _profiled_drain(hollow_store(5000, 1),
                                      pending_pods(1000, "measured"),
                                      "pallas", 1000),
        backlog=lambda: _profiled_drain(*backlog_world(), "pallas", 4096),
        # the fill's first 5 of 20 cycles: the whole drain's trace costs
        # ~1 min of the smoke's time limit to take and read
        fill=lambda: _profiled_drain(fill_world()[0], filler_pods(FILL_PODS)
                                     [:FILL_PODS // 4], "pallas", 1000),
        seq_slice=lambda: _profiled_scan_window(
            hollow_store(5000, 1), pending_pods(1000, "measured")),
        gang_spread=lambda: _profiled_rounds_window(*spread_world()),
        audit=_profiled_audit)
    out = dict(part_s={})
    for name, fn in parts.items():
        t = time.perf_counter()
        out[name] = fn()
        out["part_s"][name] = time.perf_counter() - t
    return out


# ---------------------------------------------------------------------------
# main()'s children

# ---------------------------------------------------------------------------
# guards: the sanitizer, the race harness and deploy-time kernel artifacts


def guards_drain(what, depth=1, async_binding=False, record=None,
                 metrics=None, prewarm=False):
    """The backlog's world (1,000 nodes x 4,096 900m pods) drained once
    under "pallas" (batch 4,096, the chain on, pipelined at ``depth`` > 1)
    on a frozen queue clock, so every drain of the phase pops the same
    pods in the same cycles and retries none; every auction under
    GangRounds ("error" sync debug mode); ``prewarm`` first, timed to the
    end of the first cycle.  Returns (scheduler, placements, stats)."""
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.ops import propose as PK
    from kubetpu_torch.scheduler import Scheduler
    store, pods = backlog_world()
    t0 = time.perf_counter()
    cfg = KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=4096, mode="gang",
        kernel_backend="pallas", chain_cycles=True,
        pipeline_cycles=depth > 1, pipeline_depth=depth)
    sched = Scheduler(store, config=cfg, device="cuda",
                      async_binding=async_binding, metrics=metrics)
    sched.queue._clock = _QueueClock()
    stats = dict(what=what, depth=depth, async_binding=async_binding)
    if prewarm:
        sched.prewarm()
        stats["prewarm_s"] = time.perf_counter() - t0
    for p in pods:
        store.add(p)
    restore = (_record_launches(record, None) if record is not None
               else None)
    outs = []
    PK.propose.launches = 0          # this path starts: zero the count
    try:
        with GangRounds() as gr:
            t = time.perf_counter()
            while True:
                got = sched.schedule_pending()
                if got and "first_cycle_s" not in stats:
                    stats["first_cycle_s"] = time.perf_counter() - t0
                outs.extend(got)
                if not got and not len(sched._pipeline.ring):
                    break
            outs.extend(sched.flush_pipeline())
            sched.wait_for_inflight_binds(timeout=120.0)
            stats["drain_s"] = time.perf_counter() - t
        stats["launches"] = PK.propose.launches
    finally:
        if restore is not None:
            restore()
        sched.close()
    check_no_recovery(sched, "guards " + what)
    placed = {o.pod.metadata.name: o.node for o in outs}
    stats.update(cycles=sched.cycle_count, rounds=gr.summary(),
                 placed=sum(1 for v in placed.values() if v),
                 stage_s=dict(sched.stage_s))
    if stats["launches"] <= 0:
        raise AssertionError("guards %s: K1 never launched" % what)
    return sched, placed, stats


def _hold_site(stack) -> str:
    """The innermost frame of a race-harness report outside the harness:
    where the lock was held."""
    files = [ln.strip() for ln in stack.splitlines()
             if ln.strip().startswith("File ") and "racecheck.py" not in ln]
    return files[-1] if files else "?"


def _no_nvcc_env(tmp) -> dict:
    """This process's environment with no nvcc reachable: PATH without
    any directory holding one, CUDA_HOME at an empty directory."""
    env = dict(os.environ)
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))
    env["CUDA_HOME"] = os.path.join(tmp, "no-cuda")
    os.makedirs(env["CUDA_HOME"], exist_ok=True)
    return env


def guards_child(mode, out) -> int:
    """One AOT child of the guards phase (run as ``chip_smoke.py
    --guards-child MODE --out FILE``, its environment set by the parent):
    Scheduler construction (KUBETPU_AOT_DIR arms the artifacts), prewarm
    and the backlog drain, timed to the end of the first cycle; every K1
    launch of the drain held bitwise to the plain version.  "serve" runs
    with no nvcc reachable, "corrupt" with KUBETPU_CHAOS=aot-load:corrupt:
    n=1 and nvcc.  Writes its report to FILE."""
    import torch
    from kubetpu_torch.ops import _build
    from kubetpu_torch.utils import aot, sanitize
    from kubetpu_torch.utils.metrics import SchedulerMetrics
    if not torch.cuda.is_available():
        return 1
    timer = sanitize.install_compile_timer()
    nvcc = None
    try:
        nvcc = _build.nvcc_path()
    except _build.KernelError:
        pass
    if mode == "serve" and nvcc is not None:
        raise AssertionError("guards serve child: nvcc reachable at %s"
                             % nvcc)
    metrics = SchedulerMetrics()
    record = []
    sched, placed, stats = guards_drain("aot " + mode, record=record,
                                        metrics=metrics, prewarm=True)
    rt = aot.active_runtime()
    report = dict(mode=mode, nvcc=nvcc, placed_map=placed, stats=stats,
                  source=_build.library_source.get("propose"),
                  nvcc_s=_build.build_seconds.get("propose"),
                  aot=rt.stats() if rt is not None else None,
                  demotion=aot.demotion_reason(),
                  aot_fallback=metrics.recoveries.value("aot-fallback"),
                  compile_timer=timer.snapshot(),
                  recorded=check_recorded(record, "guards aot " + mode))
    with open(out, "w") as fh:
        json.dump(report, fh)
    return 0


def _run_guards_child(mode, tmp, env, timeout_s=300) -> dict:
    out = os.path.join(tmp, mode + ".json")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--guards-child", mode,
         "--out", out], env=env, capture_output=True, text=True,
        timeout=timeout_s)
    if res.returncode != 0:
        raise AssertionError("guards %s child exited %d:\n%s"
                             % (mode, res.returncode, res.stderr[-4000:]))
    with open(out) as fh:
        doc = json.load(fh)
    doc["process_s"] = time.perf_counter() - t0
    return doc


def guards_aot() -> dict:
    """The guards phase's kernel-artifact round trip, in processes of its
    own: ``python -m kubetpu_torch.kubeaot build`` into a fresh directory
    (from an empty kernel cache, so with nvcc); then the serve child
    (KUBETPU_AOT_DIR set, an empty kernel cache, no nvcc reachable)
    prewarms from the artifact and drains; then the corrupt child
    (KUBETPU_CHAOS=aot-load:corrupt:n=1, nvcc reachable, an empty cache:
    the cold nvcc child) reads recoveries{aot-fallback} 1, rebuilds and
    drains.  phase_guards holds each child's placements to the disarmed
    drain's.  main() runs this in the card child, beside the main
    process's phases."""
    import shutil
    import tempfile
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="guards-")
    try:
        aot_dir = os.path.join(tmp, "aot")
        t = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "kubetpu_torch.kubeaot", "build", aot_dir,
             "--json"], cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ,
                     KUBETPU_KERNEL_CACHE_DIR=os.path.join(tmp, "bc")),
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError("kubeaot build exited %d:\n%s"
                                 % (res.returncode, res.stderr[-4000:]))
        built = json.loads(res.stdout)
        built["process_s"] = time.perf_counter() - t
        serve_env = dict(_no_nvcc_env(tmp), KUBETPU_AOT_DIR=aot_dir,
                         KUBETPU_KERNEL_CACHE_DIR=os.path.join(tmp, "sc"))
        serve_env.pop("KUBETPU_CHAOS", None)
        serve = _run_guards_child("serve", tmp, serve_env)
        corrupt_env = dict(os.environ, KUBETPU_AOT_DIR=aot_dir,
                           KUBETPU_KERNEL_CACHE_DIR=os.path.join(tmp, "cc"),
                           KUBETPU_CHAOS="aot-load:corrupt:n=1")
        corrupt = _run_guards_child("corrupt", tmp, corrupt_env)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if (serve["source"] != "artifact" or serve["nvcc_s"] is not None
            or serve["aot"]["hits"] != 1 or serve["aot_fallback"]):
        raise AssertionError("guards: serve child %s" % serve)
    if (corrupt["source"] != "nvcc" or corrupt["aot_fallback"] != 1
            or not corrupt["nvcc_s"]):
        raise AssertionError("guards: corrupt child %s" % corrupt)
    return dict(built=built, serve=serve, corrupt=corrupt)


def phase_guards() -> dict:
    """The JAX runtime's guard rails in the port, on the backlog's world:
    (a) the drain under the sanitizer (utils/sanitize.py: the NaN and
    rank-promotion checks of every aten op, K1's output through
    check_outputs, the card's NaN index read at each cycle's readback) has
    the disarmed drain's placements, raises nothing, trips no sync under
    GangRounds, and its watchdog counts K1's library loaded once and no
    key twice; (b) the drain pipelined at depth 2 with the binder pool
    under the race harness (utils/racecheck.py, built inside the armed
    scope) reports no unguarded mutation and no lock-order inversion, no
    hold past 5,000 ms, and has the same placements; every hold's length
    is reported by lock role; (c) guards_aot's children (the serve child
    from the artifacts with no nvcc, the corrupt child rebuilding with
    nvcc; run beside the earlier phases by main()) have the same
    placements.  Every K1 launch of every drain is held bitwise to the
    plain version."""
    from kubetpu_torch.ops import _build
    from kubetpu_torch.utils import racecheck, sanitize
    out = dict(launches=0)
    records = []
    # (a) disarmed, then sanitized (the library dropped so that the
    # sanitized drain loads it again, under the watchdog)
    record = []
    _, want, plain = guards_drain("disarmed", record=record)
    records.append(check_recorded(record, "guards disarmed"))
    _build._propose_lib = None
    record = []
    t = time.perf_counter()
    with sanitize.sanitized() as wd:
        arm_s = time.perf_counter() - t
        _, got, san = guards_drain("sanitized", record=record)
    san["arm_s"] = arm_s
    records.append(check_recorded(record, "guards sanitized"))
    lib = _build.lib_name("propose")
    counts = {"%s %s" % k: v for k, v in wd.counts.items()}
    recompiled = wd.recompiled()
    if got != want:
        raise AssertionError("guards: sanitized placements differ")
    if wd.counts.get(("load:propose", lib)) != 1 or recompiled:
        raise AssertionError("guards: watchdog %s" % counts)
    log({"guards_disarmed": plain, "guards_sanitized": san,
         "watchdog": counts})
    # (b) depth 2, binder pool, under the race harness: no unguarded
    # mutation and no lock-order inversion; holds over the default 200
    # ms are reported with the holder's CPU time over the hold, and fail
    # past the 5,000 ms that tests/test_racecheck.py gives threaded runs
    record = []
    with racecheck.racechecked(strict=False) as reg:
        _, got, race = guards_drain("racecheck", depth=2,
                                    async_binding=True, record=record)
        violations = reg.snapshot()
        with reg._mu:
            holds = {name: st.as_dict() for name, st in reg.holds.items()}
    records.append(check_recorded(record, "guards racecheck"))
    held = [v for v in violations if v.kind == "held-too-long"]
    other = [v for v in violations if v.kind != "held-too-long"]
    held_ms = [float(v.message.split(" held for ")[1].split(" ms")[0])
               for v in held]
    race["held_too_long"] = dict(
        threshold_ms=reg.hold_ms, reports=len(held),
        max_ms=max(held_ms, default=0.0), ms=sorted(held_ms),
        locks=sorted({v.message.split(" held for ")[0] for v in held}),
        sites=sorted({_hold_site(v.stack) for v in held}))
    race["holds_by_lock"] = dict(sorted(
        holds.items(), key=lambda kv: -kv[1]["max_ms"])[:12])
    log({"guards_racecheck": race})
    if other or max(held_ms, default=0.0) > 5000.0:
        raise AssertionError("guards: race harness\n%s" % "\n".join(
            str(v) for v in (other or held)))
    if got != want:
        raise AssertionError("guards: race-checked placements differ")
    # (c) the kernel-artifact round trip (guards_aot)
    aot, waited = child_result("guards aot", guards_aot)
    serve, corrupt, built = aot["serve"], aot["corrupt"], aot["built"]
    for doc in (serve, corrupt):
        if doc.pop("placed_map") != want:
            raise AssertionError("guards: %s child's placements differ"
                                 % doc["mode"])
    records += [serve["recorded"], corrupt["recorded"]]
    drains = [plain, san, race, serve["stats"], corrupt["stats"]]
    out["launches"] = sum(d["launches"] for d in drains)
    out.update(
        disarmed=plain,
        sanitized=dict(san, watchdog=counts, recompiled=len(recompiled)),
        racecheck=dict(race, violations=len(other)),
        sanitized_over_disarmed=san["drain_s"] / plain["drain_s"],
        racecheck_over_disarmed=race["drain_s"] / plain["drain_s"],
        kubeaot_build=dict(rows=[{k: r[k] for k in ("program", "bytes",
                                                    "build_s")}
                                 for r in built["rows"]],
                           process_s=built["process_s"]),
        serve=serve, corrupt=corrupt, aot_wait_s=waited,
        first_cycle_s=dict(serve=serve["stats"]["first_cycle_s"],
                           cold_nvcc=corrupt["stats"]["first_cycle_s"]),
        recorded=dict(checked=sum(r["checked"] for r in records),
                      max_abs_err=max(r["max_abs_err"] for r in records),
                      real_launch=records[0]["real_launch"]))
    log({"guards_first_cycle_s": out["first_cycle_s"],
         "serve_prewarm_s": serve["stats"]["prewarm_s"],
         "cold_prewarm_s": corrupt["stats"]["prewarm_s"],
         "serve_k1_load_s": serve["compile_timer"]["cache_load_s"],
         "cold_nvcc_s": corrupt["nvcc_s"]})
    return out


POOLS = {}     # "cpu": the reference child; "card": the card child


def cpu_ref_jobs(phase) -> list:
    """``phase``'s CPU references, (job, fn, args), in the order the
    phase collects them: the CPU halves of its card-vs-CPU drains."""
    if phase == "reference":
        return [("reference Preemption", _preempt_world_drain,
                 ("Preemption", None, "cpu")),
                ("reference terms", _preempt_world_drain,
                 ("terms", "pallas", "cpu", 8))]
    if phase == "volumes":
        return [(what, _volume_world_drain, (what, world, backend,
                                              batch_size, n_bound))
                for what, world, backend, batch_size, n_bound
                in _volume_refs()]
    if phase in ("seq_slice", "binpack"):
        return [(phase, _seq_cpu_reference, (phase,))]
    if phase == "resident":
        return [("resident 1000 %s" % (backend or "sequential"),
                 resident_drain, (1000, 100, 8, backend, "cpu", True))
                for backend in ("pallas", None)]
    if phase == "extenders":
        # its replay starts once the card drain is done (pump_children)
        return [("extenders_preempt cpu", extender_preempt_drain, ("cpu",))]
    return []


# the card child's jobs run one after another in this order of phases
CARD_JOB_ORDER = ("extenders", "serving", "chaos", "guards")


def card_jobs(phase) -> list:
    """``phase``'s jobs for the card child, beside the phases after the
    kernel's: the extender path's card drains, the entry points that run
    in processes of their own (serving's CLI and REST store, chaos' REST
    store) and the guards phase's kernel-artifact round trip."""
    if phase == "extenders":
        return [("extenders card", extender_drain, ("cuda",)),
                ("extenders_preempt card", extender_preempt_drain,
                 ("cuda",))]
    if phase == "serving":
        return [("serving cli", _serve_cli, ()),
                ("serving rest", _serve_rest, ())]
    if phase == "chaos":
        return [("chaos rest", _chaos_rest_logged, ())]
    if phase == "guards":
        return [("guards aot", guards_aot, ())]
    return []


def start_replay(card) -> None:
    """The extender drain's CPU replay (extender_cpu_replay) in the
    reference child, from the card drain's result, once."""
    if "cpu" in POOLS and "extenders replay" not in CHILD_JOBS:
        CHILD_JOBS["extenders replay"] = POOLS["cpu"].submit(
            extender_cpu_replay, card["order"], card["placed"],
            card["counters"])


def pump_children() -> None:
    """Start the child jobs that wait on another's result: the extender
    drain's CPU replay once the card child's drain is done."""
    card = CHILD_JOBS.get("extenders card")
    if card is not None and card.done() and card.exception() is None:
        start_replay(card.result())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    ap.add_argument("--guards-child", choices=("serve", "corrupt"),
                    help="run one AOT child of the guards phase")
    ap.add_argument("--out", help="the guards child's report file")
    args = ap.parse_args()
    if args.guards_child:
        return guards_child(args.guards_child, args.out)
    phases = args.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from kubetpu_torch.ops import _build
    from kubetpu_torch.ops import propose as PK
    import kubetpu_torch.utils.device  # noqa: F401  (TF32 off)

    card = card_line()
    log({"card": card, "torch": torch.__version__,
         "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    _build.load_propose()
    log({"build_s": time.perf_counter() - t0,
         "nvcc_s": _build.build_seconds.get("propose")})
    results = {}
    # both children start once the kernel phase is done (its times must
    # have the host and the card to themselves): the reference child on
    # every phase's CPU references at once, the card child on its jobs in
    # CARD_JOB_ORDER
    cpu_jobs = [j for ph in phases for j in cpu_ref_jobs(ph)]
    cards = [j for ph in CARD_JOB_ORDER if ph in phases
             for j in card_jobs(ph)]
    spawn = multiprocessing.get_context("spawn")
    try:
        for ph in phases:
            if ph != "kernel":
                if ((cpu_jobs or "journal" in phases)
                        and "cpu" not in POOLS):
                    POOLS["cpu"] = concurrent.futures.ProcessPoolExecutor(
                        1, mp_context=spawn, initializer=_ref_child_init)
                    for job, fn, args in cpu_jobs:
                        CHILD_JOBS[job] = POOLS["cpu"].submit(fn, *args)
                if cards and "card" not in POOLS:
                    POOLS["card"] = concurrent.futures.ProcessPoolExecutor(
                        1, mp_context=spawn)
                    for job, fn, args in cards:
                        CHILD_JOBS[job] = POOLS["card"].submit(fn, *args)
            t = time.perf_counter()
            results[ph] = globals()["phase_" + ph]()
            results[ph]["phase_s"] = time.perf_counter() - t
            log({"phase": ph, "card": card, **results[ph]})
            pump_children()
        if "journal" in results:
            t = time.perf_counter()
            results["journal"]["cpu_window"] = journal_cpu_check()
            log({"journal_cpu_window": results["journal"]["cpu_window"],
                 "collect_s": time.perf_counter() - t})
    finally:
        for pool in POOLS.values():
            pool.shutdown(wait=True, cancel_futures=True)
        POOLS.clear()
        CHILD_JOBS.clear()
        if "dir" in JOURNAL_CPU:     # a run that failed before collecting
            import shutil
            shutil.rmtree(JOURNAL_CPU.pop("dir"), ignore_errors=True)
    if {"kernel", *MAIN_PATHS} <= set(phases):
        # the pallas drain of each main path, counted on its own
        by_path = {ph: (results[ph]["pallas"]["launches"]
                        if ph in ("backlog", "fill", "autoscaler")
                        else results[ph]["launches"])
                   for ph in MAIN_PATHS}
        # the journal's replay on the card (kubetpu_torch.kubereplay)
        by_path["journal_replay"] = results["journal"]["replay_launches"]
        launches = sum(by_path.values())
        if launches <= 0:
            raise AssertionError("main path: the propose kernel never "
                                 "launched")
        k = results["kernel"]
        recorded = [results[ph]["pallas"]["recorded"]
                    for ph in ("backlog", "fill", "autoscaler")]
        recorded += [r["recorded"] for r in results["points"].values()
                     if isinstance(r, dict) and "recorded" in r]
        if "recorded" in results["preempt"]:
            recorded.append(results["preempt"]["recorded"])
        vol_backlog = results["volumes"]["vol_backlog"]["recorded"]
        recorded.append(vol_backlog)
        recorded.append(results["resident"]["recorded"])
        recorded.append(results["serving"]["recorded"])
        recorded.append(results["chaos"]["recorded"])
        recorded.append(results["measure"]["recorded"])
        recorded.append(results["journal"]["recorded"])
        recorded.append(results["guards"]["recorded"])
        log({"kernels": [{
            "name": "propose", "route": "cuda",
            "source": "kubetpu_torch/ops/csrc/propose.cu",
            "replaces": "kubetpu/ops/pallas_kernels.py:511",
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": max([k["max_abs_err"]]
                               + [r["max_abs_err"] for r in recorded]),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None, "matches_plain": True,
            "share_of_bound": k["share_of_bound"],
            "ms_w512": k["ms_w512"], "bound_ms_w512": k["bound_ms_w512"],
            "ms_generic": k["ms_generic"],
            "bound_ms_generic": k["bound_ms_generic"],
            "fill_real_launch": recorded[1]["real_launch"],
            "autoscaler_real_launch": recorded[2]["real_launch"],
            "vol_backlog_real_launch": vol_backlog["real_launch"],
            "resident_real_launch":
                results["resident"]["recorded"]["real_launch"],
            "serving_real_launch":
                results["serving"]["recorded"]["real_launch"],
            "chaos_real_launch":
                results["chaos"]["recorded"]["real_launch"],
            "measure_real_launch":
                results["measure"]["recorded"]["real_launch"],
            "journal_replay_real_launch":
                results["journal"]["recorded"]["real_launch"],
            "guards_real_launch":
                results["guards"]["recorded"]["real_launch"]}]})
    print(card, flush=True)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
