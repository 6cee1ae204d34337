"""Shared helpers of the port's journal, replay and devstats tests
(tests/test_torch_journal.py, test_torch_replay.py, test_torch_devstats.py).

One seeded churn world is driven through either package's scheduler with
the cycle journal (and, where asked, devstats) armed by function, never
through the shared KUBETPU_* environment names; the JAX drives run in a
spawned child (torch_port_util.jax_process), so the functions here that a
child runs are module-level and return plain data.  ``record_view`` turns
one journal record of either package into plain, comparable data: every
array leaf by its field path, the pickled payloads unpickled first."""
from __future__ import annotations

import contextlib
import copy
import fcntl
import importlib
import itertools
import json
import os
import pickle
import random
import shutil
import urllib.error
import urllib.request
from typing import Optional

import numpy as np

from kubetpu_torch.harness import preempt_worlds as PW
from tests.torch_port_util import drive, jax_process, packages

CHILD_TIMEOUT = 900.0


def _root(which: str) -> str:
    return "kubetpu" if which == "jax" else "kubetpu_torch"


def churn_scenario(seed: int, n_nodes: int = 12, n_small: int = 40):
    """A seeded preemption world (preempt_worlds: packed nodes, PDBs,
    parked nominations, preemptors that must evict) plus small pods that
    fit, a pod that fits nowhere, and churn between cycles (an external
    bind, a node label update, a deletion, a node added), so a gang
    drain's records take every input kind: resync, delta, chain and noop."""
    def scenario(A, H, store, sched):
        r = random.Random(seed)
        w = PW.world(A, seed, n_nodes, 6)
        PW.populate(store, w)
        for p, nn in w.parked:
            sched.queue.add_nominated_pod(p, nn)
        for p in w.pending:
            store.add(p)
        for i in range(n_small):
            store.add(H.make_pod(f"small-{i}", cpu_milli=100, mem=64 << 20,
                                 labels={"app": r.choice("abc")}))
        store.add(H.make_pod("too-big", cpu_milli=999999))
        yield
        yield
        ext = H.make_pod("ext-0", cpu_milli=100, labels={"app": "e"})
        ext.spec.node_name = f"n{r.randrange(n_nodes)}"
        store.add(ext)
        yield
        n = copy.deepcopy(store.get("Node", f"n{r.randrange(n_nodes)}"))
        n.metadata.labels["disk"] = "ssd"
        store.update(n)
        yield
        store.delete(store.get("Pod", "default/ext-0"))
        yield
        late = A.Node(metadata=A.ObjectMeta(
            name="n-late", labels={A.LABEL_HOSTNAME: "n-late",
                                   A.LABEL_ZONE: "z0"}),
            status=A.NodeStatus(allocatable={"cpu": "4", "memory": "8Gi",
                                             "pods": "110"}))
        store.add(late)
        yield
    return scenario


@contextlib.contextmanager
def fresh_uids(which: str):
    """Package ``which``'s object uids counted from 1 again while the
    block runs (records carry uids; a test worker has counted past 1
    before its drive, the JAX child has not), the process's own count
    restored after."""
    A = importlib.import_module(_root(which) + ".api.types")
    saved = A._uid_counter
    A._uid_counter = itertools.count(1)
    try:
        yield
    finally:
        A._uid_counter = saved


def hollow_scenario(n_nodes: int, n_pods: int = 24):
    """n_nodes empty hollow nodes in 4 zones and n_pods small pods: every
    node feasible, so a sampled search stops after its quota of nodes."""
    def scenario(A, H, store, sched):
        for n in H.make_nodes(n_nodes, zones=4):
            store.add(n)
        for p in H.make_pods(n_pods, group_labels=3):
            store.add(p)
        yield
    return scenario


def journaled_drive(which: str, jdir: str, seed: int = 31,
                    chaos_spec: str = "", devstats: bool = False,
                    max_cycles: int = 16, hollow_nodes: int = 0,
                    **sched_kw) -> dict:
    """churn_scenario(seed) (or, with hollow_nodes, hollow_scenario)
    driven through package ``which`` ("jax" or "port") with the journal
    armed on ``jdir`` (and the chaos spec, and devstats at sample interval
    1, when asked); everything disarmed again at the end.  Returns the
    per-cycle views, the final placements, the cycle count and the
    analytic device FLOPs."""
    jp, tp = packages()
    pkg = jp if which == "jax" else tp
    root = _root(which)
    uj = importlib.import_module(root + ".utils.journal")
    uchaos = importlib.import_module(root + ".utils.chaos")
    ud = importlib.import_module(root + ".utils.devstats")
    uj.disarm_journal()
    uj.arm_journal(jdir)
    if chaos_spec:
        uchaos.arm(uchaos.parse_spec(chaos_spec))
    if devstats:
        ud.disarm_devstats()
        ud.arm_devstats(sample_interval=1)
    try:
        with fresh_uids(which):
            scenario = (hollow_scenario(hollow_nodes) if hollow_nodes
                        else churn_scenario(seed))
            views, sched = drive(pkg, scenario, max_cycles=max_cycles,
                                 **sched_kw)
        out = dict(views=views, cycles=sched.cycle_count,
                   device_flops=float(sched.device_flops),
                   placements=views[-1]["pods"] if views else [])
        if devstats:
            out["ledger"] = ud.devstats().ledger()
        return out
    finally:
        uj.disarm_journal()
        uchaos.disarm()
        ud.disarm_devstats()


def two_profile_drive(which: str, jdir: str, n_pods: int = 24) -> list:
    """Gang pods of two profiles (the default and one whose
    NodeResourcesBalancedAllocation weighs 5) on 6 hollow nodes, batch 8,
    journaled: one scheduler, two resident lineages interleaved in one
    journal.  Returns the placements."""
    jp, tp = packages()
    pkg = jp if which == "jax" else tp
    uj = importlib.import_module(_root(which) + ".utils.journal")
    C = pkg.config
    heavy = C.KubeSchedulerProfile(
        scheduler_name="heavy-scheduler",
        plugins=C.Plugins(score=C.PluginSet(enabled=[
            C.Plugin("NodeResourcesBalancedAllocation", weight=5)])))
    store = pkg.store.ClusterStore()
    for n in pkg.hollow.make_nodes(6, zones=2):
        store.add(n)
    kw = dict(profiles=[C.KubeSchedulerProfile(), heavy], batch_size=8,
              mode="gang", kernel_backend="pallas")
    uj.disarm_journal()
    uj.arm_journal(jdir)
    try:
        if which == "jax":
            sched = pkg.sched.Scheduler(
                store, config=C.KubeSchedulerConfiguration(prewarm=False,
                                                           **kw),
                async_binding=False)
        else:
            sched = pkg.sched.Scheduler(
                store, config=C.KubeSchedulerConfiguration(**kw),
                device="cpu")
        with fresh_uids(which):
            pods = pkg.hollow.make_pods(n_pods, group_labels=3)
        for i, p in enumerate(pods):
            if i % 2:
                p.spec.scheduler_name = "heavy-scheduler"
            store.add(p)
        out = []
        for _ in range(12):
            got = sched.schedule_pending(timeout=0.0)
            if not got:
                break
            out.extend((o.pod.metadata.name, o.node) for o in got)
        sched.close()
        return sorted(out)
    finally:
        uj.disarm_journal()


def jax_replay(jdir: str, **kw) -> dict:
    """tools.kubereplay's report of a JAX journal (run in the child)."""
    from tools.kubereplay import replay_journal
    return replay_journal(jdir, **kw)


def report_view(report: dict) -> dict:
    """The parts of a replay report both replayers must agree on: every
    count, the skips and their reasons, the divergences with their pod
    diffs, the digests and the counterfactual block (the directory is
    left out)."""
    return {k: v for k, v in report.items() if k != "dir"}


# ---------------------------------------------------------------- records


def flat(x, path: str = "", raw: bool = False) -> dict:
    """Every leaf of a nested NamedTuple / dict / list / array structure,
    by its field path; arrays (numpy, torch or jax) as numpy, or as they
    are with ``raw``."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return {path: x}
    if hasattr(x, "_fields"):
        out = {}
        for f in x._fields:
            out.update(flat(getattr(x, f), f"{path}.{f}", raw))
        return out
    if isinstance(x, dict):
        out = {}
        for k in sorted(x, key=str):
            out.update(flat(x[k], f"{path}[{k!r}]", raw))
        return out
    if isinstance(x, (list, tuple)):
        out = {f"{path}#len": len(x)}
        for i, v in enumerate(x):
            out.update(flat(v, f"{path}[{i}]", raw))
        return out
    if raw:
        return {path: x}
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return {path: np.asarray(x)}


def _payload(rec: dict):
    p = rec.get("input_payload")
    return pickle.loads(p) if isinstance(p, (bytes, bytearray)) else p


def record_view(rec: dict) -> dict:
    """One record as plain data: its scalar fields, and its payload, batch,
    cfg, masks and packed vector flattened by field path (the timestamp
    and the flight-recorder link, which differ between two processes, are
    left out)."""
    out = {k: rec[k] for k in ("v", "seq", "cycle", "mode", "profile",
                               "input", "needs_topo", "rng_counter",
                               "start_index", "kernel_backend",
                               "hard_pod_affinity_weight", "mesh",
                               "vocab_sig", "n_nodes", "node_names",
                               "config_digest", "rounds", "pods",
                               "placements", "verdicts")}
    out["links"] = {k: v for k, v in rec["links"].items()
                    if k != "flight_seq"}
    payload = _payload(rec)
    if out["input"] == "resync":
        payload = payload.arrays
    out["payload"] = flat(payload)
    out["batch"] = flat(rec["batch"])
    out["cfg"] = flat(tuple(rec["cfg"]))
    for k in ("host_ok", "score_bias", "packed"):
        out[k] = flat(rec[k])
    return out


def assert_same_view(want: dict, got: dict, ctx: str = "") -> None:
    """Two record_views equal field by field, arrays bitwise with their
    dtypes and shapes."""
    assert set(want) == set(got), (ctx, set(want) ^ set(got))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict) and k in ("payload", "batch", "cfg",
                                         "host_ok", "score_bias", "packed"):
            assert set(w) == set(g), (ctx, k, set(w) ^ set(g))
            for path, wv in w.items():
                gv = g[path]
                if isinstance(wv, np.ndarray):
                    assert isinstance(gv, np.ndarray), (ctx, k, path)
                    assert wv.dtype == gv.dtype and wv.shape == gv.shape, (
                        ctx, k, path, wv.dtype, gv.dtype, wv.shape,
                        gv.shape)
                    assert np.array_equal(wv, gv), (ctx, k, path)
                else:
                    assert wv == gv, (ctx, k, path, wv, gv)
        else:
            assert w == g, (ctx, k, w, g)


def journal_views(jdir: str, which: str) -> list:
    """(seq, record_view or skip reason) of every record of a journal,
    read with its own package's reader."""
    uj = importlib.import_module(_root(which) + ".utils.journal")
    return [(seq, record_view(rec) if rec is not None else why)
            for seq, rec, why in uj.read_records(jdir)]


# ------------------------------------------------------- shared JAX drives
#
# The JAX drives and replays are the expensive half of these tests (each
# compiles the JAX scheduler's programs).  They run once per test run in a
# spawned child, and every worker of the run reads the result and the
# journals from one directory (the xdist pattern for a session resource
# shared across workers: the run's base temp directory, under a file
# lock).

DRIVES = {
    "gang": dict(mode="gang", backend="pallas", batch=8, max_cycles=12),
    "gang_lax": dict(mode="gang", backend="lax", batch=8, max_cycles=12),
    "seq": dict(mode="sequential", backend="lax", batch=8, max_cycles=12),
    # 40% of 256 feasible nodes: each pod's search stops after 102, so the
    # rotating start index moves between cycles
    "seq_sampled": dict(mode="sequential", backend="lax", batch=8,
                        max_cycles=4, hollow_nodes=256,
                        percentage_of_nodes_to_score=40),
}

# name -> (journal, derivation, replay keyword arguments)
REPLAYS = {
    "gang": ("gang", None, {}),
    "gang_lax": ("gang_lax", None, {}),
    "seq": ("seq", None, {}),
    "seq_sampled": ("seq_sampled", None, {}),
    "two_profiles": ("two", None, {}),
    "window": ("gang", None, {"window": (7, 10)}),
    "cf_weight": ("gang", None, {"counterfactual": {
        "score_weights": {"NodeResourcesLeastAllocated": 20}}}),
    "cf_unknown": ("gang", None, {"counterfactual": {
        "score_weights": {"NoSuchPlugin": 3}}}),
    "cf_backend": ("gang", None, {"counterfactual": {
        "kernel_backend": "lax"}}),
    "cf_depth": ("gang", None, {"counterfactual": {"pipeline_depth": 4}}),
    "truncate": ("gang", "truncate", {}),
    "corrupt": ("gang", "corrupt", {}),
    "gap": ("gang", "gap", {}),
    "tamper": ("gang", "tamper", {"keep_going": True}),
    "seq_tamper": ("seq", "tamper", {}),
}


def all_drives(which: str, root: str) -> dict:
    """Every drive of DRIVES and the two-profile drive, journaled under
    root/<name>, and the endpoint documents (endpoint_docs)."""
    out = {name: journaled_drive(which, os.path.join(root, name), **kw)
           for name, kw in DRIVES.items()}
    out["two"] = two_profile_drive(which, os.path.join(root, "two"))
    out["endpoints"] = endpoint_docs(which, os.path.join(root, "endpoints"))
    return out


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def endpoint_docs(which: str, jdir: str) -> dict:
    """/debug/journal and /debug/devicez of package ``which``'s
    SchedulerServer, disarmed and then after a gang drain (4 hollow nodes,
    16 pods and one that fits nowhere, batch 8) with the journal, devstats
    (sample interval 1), the flight recorder and the SLO tracker armed;
    plus the SLO exemplars' journal ids and the pipeline doc's journal and
    device blocks."""
    jp, tp = packages()
    pkg = jp if which == "jax" else tp
    root = _root(which)
    uj = importlib.import_module(root + ".utils.journal")
    ud = importlib.import_module(root + ".utils.devstats")
    utrace = importlib.import_module(root + ".utils.trace")
    uslo = importlib.import_module(root + ".utils.slo")
    server = importlib.import_module(root + ".server")
    C = pkg.config

    def make(store):
        kw = dict(profiles=[C.KubeSchedulerProfile()], batch_size=8,
                  mode="gang", kernel_backend="pallas")
        if which == "jax":
            return pkg.sched.Scheduler(
                store, config=C.KubeSchedulerConfiguration(prewarm=False,
                                                           **kw),
                async_binding=False)
        return pkg.sched.Scheduler(
            store, config=C.KubeSchedulerConfiguration(**kw), device="cpu")

    out = {}
    for r in (uj.disarm_journal, ud.disarm_devstats,
              utrace.disarm_flight_recorder, uslo.disarm_slo_tracker):
        r()
    store = pkg.store.ClusterStore()
    sched = make(store)
    srv = server.SchedulerServer(sched, port=0)
    port = srv.start()
    try:
        out["journal_disarmed"] = _get(port, "/debug/journal")
        out["devicez_disarmed"] = _get(port, "/debug/devicez")
    finally:
        srv.stop()
        sched.close()
    uj.arm_journal(jdir)
    ud.arm_devstats(sample_interval=1)
    fr = utrace.arm_flight_recorder(capacity=8)
    trk = uslo.arm_slo_tracker(max_exemplars=4)
    store = pkg.store.ClusterStore()
    for n in pkg.hollow.make_nodes(4, zones=2):
        store.add(n)
    sched = make(store)
    srv = server.SchedulerServer(sched, port=0)
    port = srv.start()
    try:
        for p in pkg.hollow.make_pods(16, group_labels=2):
            store.add(p)
        store.add(pkg.hollow.make_pod("too-big", cpu_milli=999999))
        for _ in range(6):
            if not sched.schedule_pending(timeout=0.0):
                break
        out["journal"] = _get(port, "/debug/journal")
        out["devicez"] = _get(port, "/debug/devicez")
        out["devicez_program"] = _get(
            port, "/debug/devicez?program=run_auction")
        out["devicez_unknown"] = _get(port, "/debug/devicez?program=nope")
        out["exemplar_journal_seqs"] = sorted(
            e["journal_seq"] for e in trk.exemplars())
        doc = fr.to_pipeline_doc(workload="endpoints")
        out["pipeline_journal"] = doc.get("journal")
        out["pipeline_device"] = doc.get("device")
        out["cycles"] = sched.cycle_count
        return out
    finally:
        srv.stop()
        sched.close()
        for r in (uj.disarm_journal, ud.disarm_devstats,
                  utrace.disarm_flight_recorder, uslo.disarm_slo_tracker):
            r()


def derive(src: str, dst: str, kind: Optional[str], which: str) -> str:
    """A copy of journal ``src`` at ``dst``, damaged as ``kind`` says:
    "truncate" cuts the third record file to half its bytes, "corrupt"
    flips a payload byte of the fourth, "gap" deletes the second, "tamper"
    re-encodes the sixth with its first pod's recorded node moved (a
    divergence the replay must attribute to that record)."""
    if kind is None:
        return src
    shutil.copytree(src, dst)
    names = sorted(n for n in os.listdir(dst) if n.endswith(".rec"))
    uj = importlib.import_module(_root(which) + ".utils.journal")
    if kind == "truncate":
        path = os.path.join(dst, names[2])
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(blob[:len(blob) // 2])
    elif kind == "corrupt":
        path = os.path.join(dst, names[3])
        with open(path, "rb") as f:
            blob = bytearray(f.read())
        mid = 17 + (len(blob) - 17) // 2
        blob[mid] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(blob))
    elif kind == "gap":
        os.unlink(os.path.join(dst, names[1]))
    elif kind == "tamper":
        path = os.path.join(dst, names[5])
        with open(path, "rb") as f:
            rec = uj.decode_record(f.read())
        packed = np.array(rec["packed"])
        packed[0] = (int(packed[0]) + 1) % int(rec["n_nodes"])
        rec["packed"] = packed
        with open(path, "wb") as f:
            f.write(uj.encode_record(rec))
    return dst


def all_replays(which: str, root: str, drives_root: str) -> dict:
    """Every replay of REPLAYS over the journals under drives_root, each
    report without its directory; the port's on the CPU."""
    if which == "jax":
        from tools.kubereplay import replay_journal
        kw0 = {}
    else:
        from kubetpu_torch.kubereplay import replay_journal
        kw0 = {"device": "cpu"}
    out = {}
    for name, (journal, kind, kw) in REPLAYS.items():
        src = derive(os.path.join(drives_root, journal),
                     os.path.join(root, name), kind, which)
        out[name] = report_view(replay_journal(src, **kw0, **kw))
    return out


def _jax_job(root: str, job: str, *args):
    """A child's job: the JAX drives, or the JAX replays of them."""
    if job == "drives":
        return all_drives("jax", root)
    if job == "replays":
        return all_replays("jax", root, *args)
    raise ValueError(job)


def shared_jax(tmp_path_factory, job: str, *args):
    """(directory, result) of ``_jax_job(directory, job, *args)``, run
    once per test run in a spawned child and shared by every worker."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / f"jax-{job}"
    with open(base / f"jax-{job}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = root / "result.pkl"
        if not done.exists():
            if root.exists():
                shutil.rmtree(root)
            root.mkdir()
            with jax_process() as ex:
                res = ex.submit(_jax_job, str(root), job,
                                *args).result(timeout=CHILD_TIMEOUT)
            tmp = root / "result.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(res, f)
            os.replace(tmp, done)
        with open(done, "rb") as f:
            return str(root), pickle.load(f)
