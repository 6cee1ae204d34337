"""Config decoding: versioned KubeSchedulerConfiguration YAML + legacy Policy.

reference: cmd/kube-scheduler/app/options/configfile.go (loadConfigFromFile),
pkg/scheduler/apis/config/v1beta1/defaults.go (defaulting),
pkg/scheduler/apis/config/validation/validation.go,
pkg/scheduler/apis/config/legacy_types.go + framework/plugins/
legacy_registry.go (v1 Policy -> plugin translation, :493/:549); the
counterpart of kubetpu/apis/load.py.  PyYAML is imported only to read a
file (load_config_file): a decoded mapping needs nothing but this module.
"""

from __future__ import annotations

from typing import Any, Dict, List

from .config import (DEFAULT_SCHEDULER_NAME, EXTENSION_POINTS,
                     KERNEL_BACKENDS, MODES, KubeSchedulerConfiguration,
                     KubeSchedulerProfile, Plugin, PluginSet, Plugins)

API_GROUP = "kubescheduler.config.k8s.io"
SUPPORTED_VERSIONS = (f"{API_GROUP}/v1beta1", f"{API_GROUP}/v1alpha2")

_EP_YAML_NAMES = {
    "queueSort": "queue_sort", "preFilter": "pre_filter", "filter": "filter",
    "preScore": "pre_score", "score": "score", "reserve": "reserve",
    "permit": "permit", "preBind": "pre_bind", "bind": "bind",
    "postBind": "post_bind", "unreserve": "unreserve",
}


class ConfigError(ValueError):
    pass


def load_config_file(path: str) -> KubeSchedulerConfiguration:
    """reference: app/options/configfile.go:40 loadConfigFromFile."""
    import yaml
    with open(path) as f:
        doc = yaml.safe_load(f)
    return load_config(doc)


def load_config(doc: Dict[str, Any]) -> KubeSchedulerConfiguration:
    if not isinstance(doc, dict):
        raise ConfigError("config must be a mapping")
    api_version = doc.get("apiVersion", "")
    kind = doc.get("kind", "")
    if kind and kind != "KubeSchedulerConfiguration":
        raise ConfigError(f"unexpected kind {kind!r}")
    if api_version and api_version not in SUPPORTED_VERSIONS:
        raise ConfigError(f"unsupported apiVersion {api_version!r}; "
                          f"supported: {SUPPORTED_VERSIONS}")
    cfg = KubeSchedulerConfiguration()
    cfg.percentage_of_nodes_to_score = doc.get("percentageOfNodesToScore", 0)
    cfg.pod_initial_backoff_seconds = doc.get("podInitialBackoffSeconds", 1.0)
    cfg.pod_max_backoff_seconds = doc.get("podMaxBackoffSeconds", 10.0)
    cfg.disable_preemption = doc.get("disablePreemption", False)
    le = doc.get("leaderElection", {}) or {}
    cfg.leader_election = bool(le.get("leaderElect", False))
    cfg.metrics_bind_address = doc.get("metricsBindAddress", "")
    cfg.health_bind_address = doc.get("healthzBindAddress", "")
    cfg.extenders = list(doc.get("extenders", []) or [])
    # the batch scheduler's extensions
    cfg.batch_size = doc.get("batchSize", 256)
    cfg.mode = doc.get("mode", "sequential")
    cfg.kernel_backend = doc.get("kernelBackend", "lax")
    # the depth-k pipelined executor (pipeline.py)
    cfg.pipeline_cycles = bool(doc.get("pipelineCycles", False))
    cfg.pipeline_depth = int(doc.get("pipelineDepth", 2))
    cfg.profiles = [_decode_profile(p) for p in doc.get("profiles", [])]
    apply_defaults(cfg)
    validate(cfg)
    return cfg


def _decode_profile(doc: Dict[str, Any]) -> KubeSchedulerProfile:
    prof = KubeSchedulerProfile(
        scheduler_name=doc.get("schedulerName", DEFAULT_SCHEDULER_NAME))
    plugins_doc = doc.get("plugins")
    if plugins_doc:
        plugins = Plugins()
        for yaml_name, attr in _EP_YAML_NAMES.items():
            ep = plugins_doc.get(yaml_name)
            if not ep:
                continue
            ps = PluginSet(
                enabled=[Plugin(p["name"], p.get("weight", 0))
                         for p in ep.get("enabled", []) or []],
                disabled=[Plugin(p["name"])
                          for p in ep.get("disabled", []) or []])
            setattr(plugins, attr, ps)
        prof.plugins = plugins
    for pc in doc.get("pluginConfig", []) or []:
        prof.plugin_config[pc["name"]] = pc.get("args", {})
    return prof


def apply_defaults(cfg: KubeSchedulerConfiguration) -> None:
    """reference: v1beta1/defaults.go SetDefaults_KubeSchedulerConfiguration."""
    if not cfg.profiles:
        cfg.profiles = [KubeSchedulerProfile()]
    for p in cfg.profiles:
        if not p.scheduler_name:
            p.scheduler_name = DEFAULT_SCHEDULER_NAME
    if cfg.batch_size <= 0:
        cfg.batch_size = 256


def validate(cfg: KubeSchedulerConfiguration,
             registry_names=None) -> None:
    """reference: validation/validation.go
    ValidateKubeSchedulerConfiguration (+ the plugin-existence and
    queue-sort checks the reference performs at framework build time,
    framework.go:205 NewFramework).

    registry_names: known plugin names for plugin-EXISTENCE checks.  When
    None (config load time), existence is NOT checked — out-of-tree
    plugins are resolvable only once the merged registry exists, so the
    Scheduler re-validates with its actual registry at construction (the
    reference likewise rejects unknown plugins at framework build time,
    framework.go:205, not at config decode)."""
    errs: List[str] = []
    if not (0 <= cfg.percentage_of_nodes_to_score <= 100):
        errs.append("percentageOfNodesToScore must be in [0, 100]")
    if cfg.pod_initial_backoff_seconds <= 0:
        errs.append("podInitialBackoffSeconds must be > 0")
    if cfg.mode not in MODES:
        errs.append("mode must be 'sequential' or 'gang'")
    if cfg.kernel_backend not in KERNEL_BACKENDS:
        errs.append("kernelBackend must be 'lax' or 'pallas'")
    if int(getattr(cfg, "pipeline_depth", 2) or 0) < 1:
        errs.append("pipelineDepth must be >= 1")
    if cfg.pod_max_backoff_seconds < cfg.pod_initial_backoff_seconds:
        errs.append("podMaxBackoffSeconds must be >= podInitialBackoffSeconds")
    names = [p.scheduler_name for p in cfg.profiles]
    if len(set(names)) != len(names):
        errs.append("duplicate scheduler name in profiles")
    known = None if registry_names is None else set(registry_names)
    queue_sorts = set()
    for p in cfg.profiles:
        hw = p.plugin_config.get("InterPodAffinity", {}) \
            .get("hardPodAffinityWeight")
        if hw is not None and not (0 <= int(hw) <= 100):
            errs.append(f"profile {p.scheduler_name}: "
                        "hardPodAffinityWeight must be in [0, 100]")
        if known is not None:
            for name in p.plugin_config:
                if name not in known:
                    errs.append(f"profile {p.scheduler_name}: pluginConfig "
                                f"for unknown plugin {name!r}")
        if p.plugins is None:
            queue_sorts.add(("PrioritySort",))   # the default queue sort
            continue
        for ep in EXTENSION_POINTS:
            ps: PluginSet = getattr(p.plugins, ep)
            seen = set()
            weight_total = 0
            for pl in ps.enabled:
                if known is not None and pl.name != "*" \
                        and pl.name not in known:
                    errs.append(f"profile {p.scheduler_name}: unknown "
                                f"plugin {pl.name!r} at {ep}")
                if pl.name in seen:
                    errs.append(f"profile {p.scheduler_name}: plugin "
                                f"{pl.name!r} enabled twice at {ep}")
                seen.add(pl.name)
                if ep == "score":
                    if pl.weight < 0:
                        errs.append(f"plugin {pl.name}: negative weight")
                    weight_total += max(pl.weight, 0)
            # the reference guards int64 overflow of total weighted score
            # (framework.go:638); our combine is exact-integer f32, so the
            # cap is 2^24 / MaxNodeScore total weight
            if ep == "score" and weight_total * 100 >= 2 ** 24:
                errs.append(f"profile {p.scheduler_name}: total score "
                            "weight too large (score sums would lose "
                            "integer exactness)")
            for pl in ps.disabled:
                if known is not None and pl.name != "*" \
                        and pl.name not in known:
                    errs.append(f"profile {p.scheduler_name}: unknown "
                                f"disabled plugin {pl.name!r} at {ep}")
        queue_sorts.add(tuple(sorted(
            pl.name for pl in p.plugins.queue_sort.enabled))
            or ("PrioritySort",))
    # all profiles must share one queue sort: there is ONE queue
    # (reference: validation.go validateCommonQueueSort)
    if len(queue_sorts) > 1:
        errs.append("all profiles must use the same queueSort plugin set")
    # extenders (reference: validation.go:129 validateExtenders)
    binders = 0
    for i, e in enumerate(cfg.extenders):
        e = e if isinstance(e, dict) else vars(e)
        if e.get("prioritizeVerb") and int(e.get("weight", 0)) <= 0:
            errs.append(f"extender[{i}]: prioritizeVerb requires a "
                        "positive weight")
        if e.get("bindVerb"):
            binders += 1
    if binders > 1:
        errs.append("only one extender can implement bind")
    if errs:
        raise ConfigError("; ".join(errs))


# ---------------------------------------------------------------------------
# legacy v1 Policy (reference: legacy_types.go + legacy_registry.go)

# predicate name -> filter plugins (reference: legacy_registry.go:146-241)
_PREDICATE_TO_PLUGINS: Dict[str, List[str]] = {
    "PodFitsResources": ["NodeResourcesFit"],
    "PodFitsHostPorts": ["NodePorts"],
    "HostName": ["NodeName"],
    "MatchNodeSelector": ["NodeAffinity"],
    "NoDiskConflict": ["VolumeRestrictions"],
    "PodToleratesNodeTaints": ["TaintToleration"],
    "CheckNodeUnschedulable": ["NodeUnschedulable"],
    "CheckVolumeBinding": ["VolumeBinding"],
    "NoVolumeZoneConflict": ["VolumeZone"],
    "MaxCSIVolumeCountPred": ["NodeVolumeLimits"],
    "MaxEBSVolumeCount": ["NodeVolumeLimits"],
    "MaxGCEPDVolumeCount": ["NodeVolumeLimits"],
    "MaxAzureDiskVolumeCount": ["NodeVolumeLimits"],
    "MatchInterPodAffinity": ["InterPodAffinity"],
    "EvenPodsSpreadPred": ["PodTopologySpread"],
    "GeneralPredicates": ["NodeResourcesFit", "NodeName", "NodePorts",
                          "NodeAffinity"],
}

# priority name -> (score plugin, also_pre_score)
_PRIORITY_TO_PLUGIN: Dict[str, str] = {
    "LeastRequestedPriority": "NodeResourcesLeastAllocated",
    "MostRequestedPriority": "NodeResourcesMostAllocated",
    "BalancedResourceAllocation": "NodeResourcesBalancedAllocation",
    "SelectorSpreadPriority": "DefaultPodTopologySpread",
    "InterPodAffinityPriority": "InterPodAffinity",
    "NodeAffinityPriority": "NodeAffinity",
    "TaintTolerationPriority": "TaintToleration",
    "ImageLocalityPriority": "ImageLocality",
    "NodePreferAvoidPodsPriority": "NodePreferAvoidPods",
    "EvenPodsSpreadPriority": "PodTopologySpread",
}

# default predicate/priority sets when the Policy omits them
# (reference: legacy_registry.go ApplyPredicatePolicy defaults)
_DEFAULT_PREDICATES = ["CheckNodeUnschedulable", "GeneralPredicates",
                      "PodToleratesNodeTaints", "NoDiskConflict",
                      "CheckVolumeBinding", "NoVolumeZoneConflict",
                      "MaxCSIVolumeCountPred", "MatchInterPodAffinity",
                      "EvenPodsSpreadPred"]
_DEFAULT_PRIORITIES = {"LeastRequestedPriority": 1,
                       "BalancedResourceAllocation": 1,
                       "NodePreferAvoidPodsPriority": 10000,
                       "NodeAffinityPriority": 1,
                       "TaintTolerationPriority": 1,
                       "InterPodAffinityPriority": 1,
                       "SelectorSpreadPriority": 1,
                       "EvenPodsSpreadPriority": 2}

_FILTER_ORDER = ["NodeUnschedulable", "NodeResourcesFit", "NodeName",
                 "NodePorts", "NodeAffinity", "VolumeRestrictions",
                 "TaintToleration", "NodeVolumeLimits", "VolumeBinding",
                 "VolumeZone", "PodTopologySpread", "InterPodAffinity"]


def load_policy(doc: Dict[str, Any]) -> KubeSchedulerConfiguration:
    """Translate a v1 Policy into a single-profile configuration
    (reference: scheduler.go:266-336 createFromConfig +
    legacy_registry.go ProcessPredicatePolicy/ProcessPriorityPolicy)."""
    if doc.get("kind") not in (None, "Policy"):
        raise ConfigError(f"unexpected kind {doc.get('kind')!r}")
    predicates = doc.get("predicates")
    priorities = doc.get("priorities")

    filter_names: List[str] = []
    if predicates is None:
        pred_names = list(_DEFAULT_PREDICATES)
    else:
        pred_names = [p["name"] for p in predicates]
    for name in pred_names:
        plugins = _PREDICATE_TO_PLUGINS.get(name)
        if plugins is None:
            raise ConfigError(f"unknown predicate {name!r}")
        for pl in plugins:
            if pl not in filter_names:
                filter_names.append(pl)
    filter_names.sort(key=lambda n: _FILTER_ORDER.index(n)
                      if n in _FILTER_ORDER else 99)

    score_weights: Dict[str, int] = {}
    if priorities is None:
        prio_items = list(_DEFAULT_PRIORITIES.items())
    else:
        prio_items = [(p["name"], p.get("weight", 1)) for p in priorities]
    for name, weight in prio_items:
        pl = _PRIORITY_TO_PLUGIN.get(name)
        if pl is None:
            raise ConfigError(f"unknown priority {name!r}")
        score_weights[pl] = score_weights.get(pl, 0) + weight

    star = [Plugin("*")]  # a Policy replaces the defaults wholesale
    plugins = Plugins(
        queue_sort=PluginSet(enabled=[Plugin("PrioritySort")], disabled=list(star)),
        pre_filter=PluginSet(enabled=[
            Plugin(n) for n in filter_names
            if n in ("NodeResourcesFit", "NodePorts", "PodTopologySpread",
                     "InterPodAffinity", "VolumeBinding")], disabled=list(star)),
        filter=PluginSet(enabled=[Plugin(n) for n in filter_names],
                         disabled=list(star)),
        pre_score=PluginSet(disabled=list(star)),
        score=PluginSet(enabled=[Plugin(n, w)
                                 for n, w in score_weights.items()],
                        disabled=list(star)),
        reserve=PluginSet(enabled=[Plugin("VolumeBinding")]
                          if "VolumeBinding" in filter_names else [],
                          disabled=list(star)),
        unreserve=PluginSet(enabled=[Plugin("VolumeBinding")]
                            if "VolumeBinding" in filter_names else [],
                            disabled=list(star)),
        pre_bind=PluginSet(enabled=[Plugin("VolumeBinding")]
                           if "VolumeBinding" in filter_names else [],
                           disabled=list(star)),
        post_bind=PluginSet(disabled=list(star)),
        permit=PluginSet(disabled=list(star)),
        bind=PluginSet(enabled=[Plugin("DefaultBinder")], disabled=list(star)),
    )
    prof = KubeSchedulerProfile(plugins=plugins)
    if "hardPodAffinitySymmetricWeight" in doc:
        prof.plugin_config["InterPodAffinity"] = {
            "hardPodAffinityWeight": doc["hardPodAffinitySymmetricWeight"]}
    cfg = KubeSchedulerConfiguration(profiles=[prof])
    cfg.extenders = list(doc.get("extenders", []) or [])
    validate(cfg)
    return cfg
