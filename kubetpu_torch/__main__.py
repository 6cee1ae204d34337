"""Executable scheduler: ``python -m kubetpu_torch --config cfg.yaml``.

reference: cmd/kube-scheduler/scheduler.go:1 (main), app/server.go:69-218
(NewSchedulerCommand / Run: config load -> health+metrics serving -> event
broadcasting -> leader election -> scheduler.Run) and app/options/ (the flag
surface).  Standalone runs play the kubemark/hollow tier: ``--hollow-nodes``
populates an in-process store the way hollow kubelets register themselves
(pkg/kubemark/hollow_kubelet.go:35); ``--api-port`` serves that store over
REST and ``--api-server`` schedules against a remote one.  The counterpart
of ``python -m kubetpu``, with ``--device`` (default ``cuda``; ``cpu`` runs
the plain PyTorch path).

Exit codes: 0 clean shutdown; 1 lease lost (server.go:217 — losing the
lease is fatal so a standby takes over); 2 bad flags/config.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m kubetpu_torch",
        description="batch scheduler on a CUDA card (kube-scheduler "
                    "parity build)")
    p.add_argument("--config", help="KubeSchedulerConfiguration YAML "
                   "(app/options/configfile.go:40)")
    p.add_argument("--mode", choices=("sequential", "gang"),
                   help="override the device execution mode (sequential = "
                        "bit-parity serial replay; gang = conflict-free "
                        "auction, the throughput mode)")
    p.add_argument("--batch-size", type=int, help="override batch size")
    p.add_argument("--port", type=int, default=0,
                   help="healthz/metrics/configz port (0 = ephemeral; the "
                   "bound port is printed as a JSON line on startup)")
    p.add_argument("--leader-elect", action="store_true",
                   help="enable leader election (overrides config)")
    p.add_argument("--lock-file",
                   help="lease file for cross-process leader election")
    p.add_argument("--lock-identity", help="holder identity (default: pid)")
    p.add_argument("--lease-duration", type=float, default=15.0)
    p.add_argument("--retry-period", type=float, default=2.0)
    p.add_argument("--hollow-nodes", type=int, default=0,
                   help="populate N hollow nodes into the in-process store")
    p.add_argument("--hollow-existing", type=int, default=0,
                   help="pre-bound pods per hollow node")
    p.add_argument("--hollow-pods", type=int, default=0,
                   help="pending hollow pods to enqueue")
    p.add_argument("--once", action="store_true",
                   help="drain the pending queue, print a summary JSON "
                   "line, and exit (the scheduler_perf harness mode)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--drain-timeout", type=float, default=300.0,
                   help="--once: give up draining after this many seconds")
    p.add_argument("--api-port", type=int, default=-1,
                   help="serve the cluster store as a REST resource API "
                        "(list/get/create/delete, pods/binding + status "
                        "subresources, long-poll watch) on this port; 0 "
                        "picks a free port; -1 (default) disables")
    p.add_argument("--device", default="cuda",
                   help="torch device of the device programs (default "
                        "cuda; cpu runs the plain PyTorch path)")
    p.add_argument("--api-server",
                   help="connect to a REMOTE API server at this "
                        "base URL instead of using an in-process store "
                        "(reflector-fed local cache; writes go over HTTP)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from .apis.config import (KubeSchedulerConfiguration,
                              KubeSchedulerProfile)
    from .apis.load import ConfigError, load_config_file
    from .client.store import ClusterStore
    from .scheduler import Scheduler
    from .server import SchedulerServer
    from .utils.metrics import SchedulerMetrics

    if args.config:
        try:
            config = load_config_file(args.config)
        except (ConfigError, OSError) as e:
            print(f"error loading --config: {e}", file=sys.stderr)
            return 2
    else:
        config = KubeSchedulerConfiguration(
            profiles=[KubeSchedulerProfile()])
    if args.mode:
        config.mode = args.mode
    if args.batch_size:
        config.batch_size = args.batch_size
    if args.leader_elect:
        config.leader_election = True

    if args.api_server:
        from .client.rest import RestClusterStore
        store = RestClusterStore(args.api_server)
        if not store.wait_for_cache_sync(timeout=30.0):
            # reference: WaitForCacheSync failure is fatal — serving
            # against an unsynced (empty) cache schedules into the void
            print(f"error: could not sync cache from {args.api_server}",
                  file=sys.stderr)
            return 1
    else:
        store = ClusterStore()
    api_srv = None
    if args.api_port >= 0 and not args.api_server:
        from .client.rest import APIServer
        api_srv = APIServer(store, port=args.api_port)
        api_port = api_srv.start()
        print(json.dumps({"kubetpu": "api", "port": api_port}), flush=True)
    metrics = SchedulerMetrics()
    try:
        # binding on the pool, the JAX package's default
        sched = Scheduler(store, config=config, metrics=metrics,
                          seed=args.seed, device=args.device,
                          async_binding=True)
    except (ConfigError, NotImplementedError) as e:
        print(f"invalid configuration: {e}", file=sys.stderr)
        return 2

    if args.hollow_nodes or args.hollow_pods:
        from .harness import hollow
        for i, n in enumerate(hollow.make_nodes(args.hollow_nodes, zones=8)):
            store.add(n)
            for p in hollow.make_pods(args.hollow_existing,
                                      prefix=f"ex-{i}-", group_labels=16):
                p.spec.node_name = n.name
                store.add(p)
        for p in hollow.make_pods(args.hollow_pods, prefix="pend-",
                                  group_labels=16):
            store.add(p)

    server = SchedulerServer(sched, port=args.port)
    port = server.start()
    print(json.dumps({"kubetpu": "started", "port": port,
                      "mode": config.mode,
                      "profiles": [pr.scheduler_name
                                   for pr in config.profiles]}), flush=True)

    stop = threading.Event()
    exit_code = [0]

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    def serve():
        try:
            if args.once:
                # drain: run cycles until no pod is actively retryable —
                # pods parked in unschedulableQ with no cluster event coming
                # are terminal for a --once run
                t0 = time.time()
                deadline = t0 + args.drain_timeout
                outcomes = []
                while not stop.is_set() and time.time() < deadline:
                    sched.queue.flush_backoff_completed()
                    out = sched.schedule_pending(timeout=0.2)
                    outcomes.extend(out)
                    if (not out and len(sched.queue.active_q) == 0
                            and len(sched.queue.backoff_q) == 0):
                        break
                sched.wait_for_inflight_binds()
                bound = sum(1 for o in outcomes if o.node and not o.err)
                print(json.dumps({
                    "scheduled": bound,
                    "attempts": len(outcomes),
                    "unschedulable": len(sched.queue.unschedulable_q),
                    "seconds": round(time.time() - t0, 3),
                }), flush=True)
            else:
                sched.run()
                stop.wait()
        finally:
            stop.set()

    if config.leader_election:
        from .utils.leaderelection import FileLock, InMemoryLock, LeaderElector
        lock = FileLock(args.lock_file) if args.lock_file else InMemoryLock()
        started = threading.Event()
        serving: List[threading.Thread] = []

        def on_started():
            started.set()
            t = threading.Thread(target=serve, daemon=True)
            serving.append(t)
            t.start()

        def on_stopped():
            # reference: app/server.go:217 — losing the lease is fatal
            print(json.dumps({"kubetpu": "lease lost, exiting"}),
                  flush=True)
            exit_code[0] = 1
            stop.set()

        import os
        elector = LeaderElector(lock, on_started, on_stopped,
                                identity=args.lock_identity
                                or f"pid-{os.getpid()}",
                                lease_duration=args.lease_duration,
                                retry_period=args.retry_period)
        elector.run(block=False)
        stop.wait()
        elector.release()
    else:
        serve()
        stop.wait()

    sched.close()
    # the serving thread may still be in the prewarm or a cycle: the
    # interpreter must not exit under a thread inside torch, which aborts
    for t in serving if config.leader_election else ():
        t.join(timeout=60.0)
    server.stop()
    return exit_code[0]


if __name__ == "__main__":
    sys.exit(main())
