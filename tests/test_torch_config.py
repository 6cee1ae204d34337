"""tests/test_config.py through both packages: component-config decoding,
defaulting and validation, legacy Policy translation and feature gates
(reference: pkg/scheduler/apis/config tests, legacy_registry_test.go).

Each case runs on kubetpu.apis / kubetpu.framework and on the port's
copies: the decoded configurations, the frameworks built from them and the
validation errors must agree, and the original's assertions hold on the
port.
"""
import dataclasses

import pytest

from tests.torch_port_util import framework_packages
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

PACKAGES = framework_packages()
JAX, PORT = PACKAGES
CONFIG_FIELDS = ("percentage_of_nodes_to_score",
                 "pod_initial_backoff_seconds", "pod_max_backoff_seconds",
                 "disable_preemption", "extenders", "batch_size", "mode",
                 "kernel_backend", "leader_election", "metrics_bind_address",
                 "health_bind_address", "pipeline_cycles", "pipeline_depth",
                 "dispatch_deadline_seconds", "bind_retries", "prewarm",
                 "chain_cycles")


def config_view(cfg):
    return ({f: getattr(cfg, f) for f in CONFIG_FIELDS},
            [dataclasses.asdict(p) for p in cfg.profiles])


def fw_view(fwk):
    """A framework's plugin sets at every extension point."""
    return dict(
        tensor_filters=fwk.tensor_filters, tensor_scores=fwk.tensor_scores,
        score_weights=fwk.score_weights,
        hard=fwk.hard_pod_affinity_weight,
        points={ep: [p.name() for p in getattr(fwk, ep + "_plugins")]
                for ep in ("queue_sort", "pre_filter", "filter",
                           "post_filter", "pre_score", "score", "reserve",
                           "permit", "pre_bind", "bind", "post_bind",
                           "unreserve")})


def framework(P, profile):
    return P.runtime.Framework(P.intree.new_in_tree_registry(), profile)


def load_both(doc):
    cfgs = [P.load.load_config(doc) for P in PACKAGES]
    assert config_view(cfgs[0]) == config_view(cfgs[1])
    return cfgs[1]


def raises_both(fn, match):
    """fn(P) raises a ConfigError matching ``match`` in both packages,
    with the same message."""
    msgs = []
    for P in PACKAGES:
        with pytest.raises(P.load.ConfigError, match=match) as e:
            fn(P)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_load_config_yaml():
    doc = {
        "apiVersion": "kubescheduler.config.k8s.io/v1beta1",
        "kind": "KubeSchedulerConfiguration",
        "podInitialBackoffSeconds": 2,
        "podMaxBackoffSeconds": 20,
        "profiles": [
            {"schedulerName": "default-scheduler"},
            {"schedulerName": "no-spread",
             "plugins": {"score": {
                 "disabled": [{"name": "PodTopologySpread"}],
                 "enabled": [{"name": "NodeResourcesMostAllocated",
                              "weight": 5}]}},
             "pluginConfig": [{"name": "InterPodAffinity",
                               "args": {"hardPodAffinityWeight": 10}}]},
        ],
    }
    cfg = load_both(doc)
    assert cfg.pod_initial_backoff_seconds == 2
    assert len(cfg.profiles) == 2
    views = [fw_view(framework(P, P.load.load_config(doc).profiles[1]))
             for P in PACKAGES]
    assert views[0] == views[1]
    fwk = framework(PORT, cfg.profiles[1])
    names = [p.name() for p in fwk.score_plugins]
    assert "PodTopologySpread" not in names
    assert "NodeResourcesMostAllocated" in names
    assert fwk.score_weights["NodeResourcesMostAllocated"] == 5
    assert fwk.hard_pod_affinity_weight == 10
    assert ("NodeResourcesMostAllocated", 5) in fwk.tensor_scores


def test_bad_api_version_rejected():
    raises_both(lambda P: P.load.load_config(
        {"apiVersion": "kubescheduler.config.k8s.io/v1",
         "kind": "KubeSchedulerConfiguration"}), "unsupported apiVersion")


def test_validation_errors():
    raises_both(lambda P: P.load.load_config(
        {"percentageOfNodesToScore": 150}), "percentageOfNodesToScore")
    raises_both(lambda P: P.load.load_config(
        {"profiles": [{"schedulerName": "a"}, {"schedulerName": "a"}]}),
        "duplicate")
    raises_both(lambda P: P.load.load_config(
        {"podInitialBackoffSeconds": 5, "podMaxBackoffSeconds": 1}),
        "podMaxBackoffSeconds")


def test_defaults_applied():
    cfg = load_both({})
    assert len(cfg.profiles) == 1
    assert cfg.profiles[0].scheduler_name == "default-scheduler"
    assert cfg.batch_size == 256


def test_policy_translation():
    policy = {
        "kind": "Policy",
        "predicates": [{"name": "PodFitsResources"},
                       {"name": "PodFitsHostPorts"}],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 2},
                       {"name": "BalancedResourceAllocation", "weight": 3},
                       {"name": "InterPodAffinityPriority", "weight": 1}],
        "hardPodAffinitySymmetricWeight": 7,
    }
    cfgs = [P.load.load_policy(policy) for P in PACKAGES]
    assert config_view(cfgs[0]) == config_view(cfgs[1])
    views = [fw_view(framework(P, c.profiles[0]))
             for P, c in zip(PACKAGES, cfgs)]
    assert views[0] == views[1]
    fwk = framework(PORT, cfgs[1].profiles[0])
    assert fwk.tensor_filters == ("NodeResourcesFit", "NodePorts")
    assert dict(fwk.tensor_scores) == {"NodeResourcesLeastAllocated": 2,
                                       "NodeResourcesBalancedAllocation": 3,
                                       "InterPodAffinity": 1}
    assert fwk.hard_pod_affinity_weight == 7
    assert [p.name() for p in fwk.bind_plugins] == ["DefaultBinder"]


def test_policy_default_sets():
    cfgs = [P.load.load_policy({"kind": "Policy"}) for P in PACKAGES]
    assert config_view(cfgs[0]) == config_view(cfgs[1])
    # the default predicates enable the volume family: the Policy's
    # frameworks build and equal the JAX package's at every point
    views = [fw_view(framework(P, c.profiles[0]))
             for P, c in zip(PACKAGES, cfgs)]
    assert views[0] == views[1]
    assert "VolumeBinding" in views[1]["points"]["filter"]
    assert "VolumeBinding" in views[1]["points"]["pre_bind"]
    fwk = framework(PORT, cfgs[1].profiles[0])
    assert "NodeResourcesFit" in fwk.tensor_filters
    assert "InterPodAffinity" in fwk.tensor_filters
    weights = dict(fwk.tensor_scores)
    assert weights["NodePreferAvoidPods"] == 10000
    assert weights["PodTopologySpread"] == 2


@pytest.mark.parametrize("name", [
    "NoDiskConflict", "CheckVolumeBinding", "NoVolumeZoneConflict",
    "MaxCSIVolumeCountPred", "MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
    "MaxAzureDiskVolumeCount"])
def test_policy_volume_predicate_builds(name):
    """A Policy naming one legacy volume predicate builds a Framework in
    both packages, with the same plugins at every point."""
    cfgs = [P.load.load_policy({"kind": "Policy",
                                "predicates": [{"name": name}]})
            for P in PACKAGES]
    views = [fw_view(framework(P, c.profiles[0]))
             for P, c in zip(PACKAGES, cfgs)]
    assert views[0] == views[1]
    assert views[1]["points"]["filter"]


def test_policy_unknown_predicate():
    raises_both(lambda P: P.load.load_policy(
        {"predicates": [{"name": "Bogus"}]}), "unknown predicate")


def test_feature_gates():
    for P in PACKAGES:
        fg = P.features.FeatureGate()
        assert fg.enabled("EvenPodsSpread")
        assert not fg.enabled("BalanceAttachedNodeVolumes")
        fg.set("BalanceAttachedNodeVolumes", True)
        assert fg.enabled("BalanceAttachedNodeVolumes")
        with pytest.raises(KeyError):
            fg.enabled("NoSuchGate")
        with pytest.raises(ValueError):
            fg.set("VolumeScheduling", False)   # locked to default
        fg2 = P.features.FeatureGate()
        fg2.set("AllAlpha", True)
        assert fg2.enabled("NonPreemptingPriority")
    assert (JAX.features.DEFAULT_FEATURES
            == PORT.features.DEFAULT_FEATURES)


def test_validation_unknown_plugin():
    """Plugin existence is checked against the registry the scheduler
    builds from, never at config load."""
    doc = {"apiVersion": "kubescheduler.config.k8s.io/v1beta1",
           "profiles": [{"schedulerName": "s",
                         "plugins": {"score": {
                             "enabled": [{"name": "Bogus"}]}}}]}
    cfg = load_both(doc)
    raises_both(lambda P: P.load.validate(
        P.load.load_config(doc),
        registry_names=set(P.intree.new_in_tree_registry())),
        "unknown plugin 'Bogus'")
    for P in PACKAGES:
        P.load.validate(P.load.load_config(doc), registry_names=set(
            P.intree.new_in_tree_registry()) | {"Bogus"})
    with pytest.raises(PORT.load.ConfigError, match="unknown plugin 'Bogus'"):
        PORT.sched.Scheduler(PORT.store.ClusterStore(), config=cfg,
                             device="cpu")


def test_validation_bad_score_weight():
    raises_both(lambda P: P.load.load_config({
        "profiles": [{"schedulerName": "s",
                      "plugins": {"score": {"enabled": [
                          {"name": "ImageLocality", "weight": -1}]}}}]}),
        "negative weight")
    raises_both(lambda P: P.load.load_config({
        "profiles": [{"schedulerName": "s",
                      "plugins": {"score": {"enabled": [
                          {"name": "ImageLocality",
                           "weight": 2 ** 24}]}}}]}),
        "integer exactness")


def test_validation_percentage_range():
    raises_both(lambda P: P.load.load_config(
        {"percentageOfNodesToScore": 150}), "percentageOfNodesToScore")


def test_validation_duplicate_plugin_and_queue_sort():
    raises_both(lambda P: P.load.load_config({
        "profiles": [{"schedulerName": "s",
                      "plugins": {"filter": {"enabled": [
                          {"name": "NodeName"}, {"name": "NodeName"}]}}}]}),
        "enabled twice")
    raises_both(lambda P: P.load.load_config({
        "profiles": [
            {"schedulerName": "a"},
            {"schedulerName": "b",
             "plugins": {"queueSort": {
                 "enabled": [{"name": "NodeName"}],
                 "disabled": [{"name": "*"}]}}}]}),
        "same queueSort")


def test_validation_hard_pod_affinity_weight():
    raises_both(lambda P: P.load.load_config({
        "profiles": [{"schedulerName": "s",
                      "pluginConfig": [{
                          "name": "InterPodAffinity",
                          "args": {"hardPodAffinityWeight": 1000}}]}]}),
        "hardPodAffinityWeight")


def test_validation_extender_rules():
    """Extenders decode and validate as in the JAX package; a Scheduler
    given one refuses it (ROADMAP queue 1 item 8)."""
    raises_both(lambda P: P.load.load_config({"extenders": [
        {"urlPrefix": "http://x", "prioritizeVerb": "prioritize",
         "weight": 0}]}), "positive weight")
    raises_both(lambda P: P.load.load_config({"extenders": [
        {"urlPrefix": "http://x", "bindVerb": "bind"},
        {"urlPrefix": "http://y", "bindVerb": "bind"}]}), "one extender")
    cfg = load_both({"extenders": [{"urlPrefix": "http://x",
                                    "filterVerb": "filter"}]})
    with pytest.raises(NotImplementedError, match="item 8"):
        PORT.sched.Scheduler(PORT.store.ClusterStore(), config=cfg,
                             device="cpu")


@pytest.mark.parametrize("seconds", [0, -1])
def test_validation_initial_backoff_positive(seconds):
    """podInitialBackoffSeconds must be > 0 in both packages, as upstream
    (validation.go)."""
    raises_both(lambda P: P.load.load_config(
        {"podInitialBackoffSeconds": seconds}),
        "podInitialBackoffSeconds must be > 0")


@pytest.mark.parametrize("doc", [
    {"leaderElection": {"leaderElect": True}},
    {"metricsBindAddress": "0.0.0.0:10251"},
    {"healthzBindAddress": "0.0.0.0:10251"},
    {"pipelineCycles": True},
    {"pipelineDepth": 3},
])
def test_serving_settings_refused(doc):
    """The serving loop's settings (leader election, the metrics and
    health addresses, the pipelined drain) decode in the port as in the
    JAX package: the same fields, the same values, the same defaults for
    the rest (the dispatch deadline, bind retries, prewarm).  The port
    refused them until its serving loop existed; it now reads each."""
    cfg = load_both(doc)
    assert config_view(cfg) == config_view(JAX.load.load_config(doc))
    load_both({"leaderElection": {"leaderElect": False},
               "pipelineCycles": False})


@pytest.mark.parametrize("depth", [0, -2])
def test_serving_settings_validated(depth):
    """pipelineDepth must be >= 1 in both packages, with the same
    message."""
    raises_both(lambda P: P.load.load_config({"pipelineDepth": depth}),
                "pipelineDepth must be >= 1")
