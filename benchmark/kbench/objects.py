"""The plain data of spec.py as the program's API objects, and the
scheduler a configuration file describes.

The node and pod shapes follow kubemark's hollow nodes and scheduler_perf's
pod templates (the makers are a frozen copy of the program's hollow
cluster helpers, so the yardstick does not move with the program).  A
template's features add themselves to the pod (``features/<key>.py``).
"""

from __future__ import annotations

from .spec import Template, World


def api():
    from kubetpu_torch.api import types
    return types


def make_node(world: World, i: int):
    a = api()
    name = world.node_name(i)
    labels = world.node_labels(i)
    alloc = {"cpu": "%dm" % int(world.alloc_cpu[i]),
             "memory": str(int(world.alloc_mem[i])),
             "pods": str(int(world.alloc_pods[i]))}
    return a.Node(metadata=a.ObjectMeta(name=name, labels=labels),
                  status=a.NodeStatus(allocatable=dict(alloc),
                                      capacity=dict(alloc)))


def make_pod(world: World, name: str, t: Template, node_name: str = ""):
    a = api()
    req = {"cpu": "%dm" % t.cpu_milli, "memory": str(t.mem_bytes)}
    pod = a.Pod(
        metadata=a.ObjectMeta(name=name, namespace="default",
                              labels=dict(t.labels)),
        spec=a.PodSpec(
            priority=t.priority, node_name=node_name,
            containers=[a.Container(
                name="c", image="k8s.gcr.io/pause:3.2",
                resources=a.ResourceRequirements(requests=req))]))
    for key, _ in t.features:
        world.plugins.feature(key).to_pod(pod, t.feature(key), a)
    return pod


def scheduler_config(config: dict):
    """The KubeSchedulerConfiguration of a configuration file: one profile
    (the default plugin set with the file's score plugins enabled and
    disabled over it) and the file's mode, route, batch, chain and
    pipeline settings."""
    from kubetpu_torch.apis import config as C
    sched = config["scheduler"]
    plugins = None
    if sched.get("score_enable") or sched.get("score_disable"):
        plugins = C.Plugins(score=C.PluginSet(
            enabled=[C.Plugin(n, int(w)) for n, w in sched["score_enable"]],
            disabled=[C.Plugin(n) for n in sched["score_disable"]]))
    cfg = C.KubeSchedulerConfiguration(
        profiles=[C.KubeSchedulerProfile(plugins=plugins)],
        batch_size=int(config["batch_size"]))
    cfg.mode = sched["mode"]
    cfg.kernel_backend = sched["kernel_backend"]
    cfg.chain_cycles = bool(sched["chain_cycles"])
    cfg.pipeline_cycles = bool(sched["pipeline_cycles"])
    return cfg
