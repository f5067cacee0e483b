"""Platform manifest renderer (the ksonnet/kustomize package registry
equivalent, in code).

Port of `kubeflow_tpu/tpctl/manifests.py`. The reference shipped its
components as ksonnet packages in an external registry and later
kustomize. Here every component renders as plain dict objects from one
place, with kustomize-style overlay patches applied last, so `tpctl
generate` is the whole registry. The port's renderer installs the port's
CRDs (JAXJob, JAXService, Notebook, Profile, PodDefault, Tensorboard,
StudyJob), launches the port's modules (`python -m
kubeflow_tpu_torch....`) and names images under the port's prefix.

`MODULES` holds every module a rendered Deployment launches. The web
apps not yet ported (`UNPORTED`: the dashboard and the Tensorboards web
app) are named by the module the port will give them; until it exists,
`find_spec` finds no such module and a pod of it would fail at start:
nothing here runs one, and ROADMAP.md lists each.
"""

from __future__ import annotations

from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.tpctl.tpudef import TpuDef


# the module each component's Deployment runs (`python -m MODULE`)
MODULES = {
    "jaxjob-controller": "kubeflow_tpu_torch.control.jaxjob",
    "gang-scheduler": "kubeflow_tpu_torch.control.scheduler",
    "jaxservice-controller": "kubeflow_tpu_torch.control.jaxservice",
    "notebook-controller": "kubeflow_tpu_torch.control.notebook",
    "profile-controller": "kubeflow_tpu_torch.control.profile",
    "tensorboard-controller": "kubeflow_tpu_torch.control.tensorboard",
    "poddefault-webhook": "kubeflow_tpu_torch.control.poddefault",
    "kfam": "kubeflow_tpu_torch.control.kfam",
    "gatekeeper": "kubeflow_tpu_torch.control.gatekeeper",
    "centraldashboard": "kubeflow_tpu_torch.webapps.dashboard_main",
    "jupyter-web-app": "kubeflow_tpu_torch.webapps.jwa_main",
    "tensorboards-web-app": "kubeflow_tpu_torch.webapps.tensorboards_main",
    "serving": "kubeflow_tpu_torch.serving",
    "metric-collector": "kubeflow_tpu_torch.metric_collector",
}
# the components whose module the port does not have yet (ROADMAP
# Queue 1 item 4): rendered, so a deployment's shape is whole, and run
# by nothing until they exist
UNPORTED = frozenset({"centraldashboard", "tensorboards-web-app"})
CONTROLLERS = ("jaxjob-controller", "gang-scheduler", "jaxservice-controller",
               "notebook-controller", "profile-controller",
               "tensorboard-controller")
# the platform services and web apps, by their container port
SERVICE_PORTS = {
    "kfam": 8081,
    "gatekeeper": 8085,
    "centraldashboard": 8082,
    "jupyter-web-app": 5000,
    "tensorboards-web-app": 5005,
    "serving": 8500,
    "metric-collector": 8088,
}


def launched_modules(objs: list[dict]) -> list[str]:
    """The modules the rendered Deployments launch (`python -m M`), in
    render order."""
    out = []
    for o in objs:
        if o.get("kind") != "Deployment":
            continue
        for c in o["spec"]["template"]["spec"]["containers"]:
            args = c.get("args") or []
            if args[:2] == ["python", "-m"]:
                out.append(args[2])
    return out


def _deployment(name: str, ns: str, image: str, *, args: list[str] | None = None,
                env: dict[str, str] | None = None, port: int | None = None,
                sa: str | None = None, replicas: int = 1) -> dict:
    container: dict = {"name": name, "image": image}
    if args:
        container["args"] = args
    if env:
        container["env"] = [{"name": k, "value": v} for k, v in sorted(env.items())]
    if port:
        container["ports"] = [{"containerPort": port}]
    pod_spec: dict = {"containers": [container]}
    if sa:
        pod_spec["serviceAccountName"] = sa
    return ob.new_object(
        "apps/v1", "Deployment", name, ns,
        labels={"app": name, "app.kubernetes.io/part-of": "kubeflow-tpu"},
        spec={
            "replicas": replicas,
            "selector": {"matchLabels": {"app": name}},
            "template": {"metadata": {"labels": {"app": name}},
                         "spec": pod_spec},
        },
    )


def _service(name: str, ns: str, port: int, target: int,
             scheme: str = "http") -> dict:
    # the port-name prefix drives Istio protocol selection: a TLS backend
    # behind an 'http-' port would have its ClientHello parsed as
    # plaintext by a mesh sidecar
    return ob.new_object(
        "v1", "Service", name, ns,
        spec={"selector": {"app": name},
              "ports": [{"name": f"{scheme}-{name}", "port": port,
                         "targetPort": target}]},
    )


def _webapps_virtualservice(ns: str, prefixes: dict[str, str]) -> dict:
    """ONE gateway VirtualService carrying every web-app prefix route,
    most-specific first. A single VS (vs one per app) because Istio's
    merge order across VirtualServices on the same host is
    non-deterministic — a separate '/' catch-all could shadow /jupyter/.
    Per-resource routes (/notebook/<ns>/<name>/) are added by the
    controllers, not here."""
    http = []
    for name, prefix in sorted(prefixes.items(),
                               key=lambda kv: -len(kv[1])):
        if prefix == "/":
            # the dashboard must NOT get a '/' prefix catch-all: the
            # notebook/tensorboard controllers create per-resource
            # VirtualServices (/notebook/<ns>/<name>/) on the same host,
            # and Istio's cross-VS merge order could let a catch-all
            # shadow them. Enumerate the dashboard's own surfaces
            # instead; unknown paths 404 at the gateway, deterministically.
            match = [{"uri": {"exact": "/"}},
                     {"uri": {"prefix": "/dashboard"}},
                     {"uri": {"prefix": "/api/"}}]
        else:
            match = [{"uri": {"prefix": prefix}}]
        rule: dict = {
            "match": match,
            "route": [{"destination": {
                "host": f"{name}.{ns}.svc.cluster.local",
                "port": {"number": 80}}}],
        }
        if prefix != "/":
            # apps are served at their own root; strip the gateway prefix
            rule["rewrite"] = {"uri": "/"}
        http.append(rule)
    return ob.new_object(
        "networking.istio.io/v1alpha3", "VirtualService",
        "kubeflow-webapps", ns,
        spec={"hosts": ["*"], "gateways": ["kubeflow/kubeflow-gateway"],
              "http": http},
    )


def _clusterrole(name: str, rules: list[dict]) -> dict:
    cr = ob.new_object("rbac.authorization.k8s.io/v1", "ClusterRole", name)
    cr["rules"] = rules
    return cr


def render(cfg: TpuDef) -> list[dict]:
    """All manifests for the selected applications, in apply order."""
    ns = cfg.namespace
    img = lambda c: f"{cfg.image_prefix}/{c}:latest"  # noqa: E731
    out: list[dict] = []
    apps = set(cfg.applications)

    if "crds" in apps:
        from kubeflow_tpu_torch.control.jaxjob import types as JT
        from kubeflow_tpu_torch.control.jaxservice import types as ST
        from kubeflow_tpu_torch.control.notebook import types as NT
        from kubeflow_tpu_torch.control.poddefault import webhook as PW
        from kubeflow_tpu_torch.control.profile import types as PT
        from kubeflow_tpu_torch.control.tensorboard import controller as TB
        from kubeflow_tpu_torch.tune import studyjob as SJ

        out += [JT.crd_manifest(), ST.crd_manifest(), NT.crd_manifest(),
                PT.crd_manifest(), PW.crd_manifest(), TB.crd_manifest(),
                SJ.crd_manifest()]

    if "namespace" in apps:
        out.append(ob.new_object(
            "v1", "Namespace", ns,
            labels={"istio-injection": "enabled" if cfg.use_istio else "disabled"}))

    if "rbac" in apps:
        # the kubeflow-{admin,edit,view} ClusterRoles the profile
        # controller and KFAM bind to (profile_controller.go:58-62)
        every = [{"apiGroups": ["*"], "resources": ["*"], "verbs": ["*"]}]
        ro = [{"apiGroups": ["*"], "resources": ["*"],
               "verbs": ["get", "list", "watch"]}]
        out += [
            _clusterrole("kubeflow-admin", every),
            _clusterrole("kubeflow-edit", [
                {"apiGroups": ["", "apps", "kubeflow.org",
                               "tensorboard.kubeflow.org"],
                 "resources": ["*"], "verbs": ["*"]}]),
            _clusterrole("kubeflow-view", ro),
            ob.new_object("v1", "ServiceAccount", "kubeflow-controller", ns),
        ]
        crb = ob.new_object("rbac.authorization.k8s.io/v1", "ClusterRoleBinding",
                            "kubeflow-controller-admin")
        crb["roleRef"] = {"apiGroup": "rbac.authorization.k8s.io",
                          "kind": "ClusterRole", "name": "kubeflow-admin"}
        crb["subjects"] = [{"kind": "ServiceAccount",
                            "name": "kubeflow-controller", "namespace": ns}]
        out.append(crb)

    for name in CONTROLLERS:
        if name not in apps:
            continue
        cmd = ["python", "-m", MODULES[name]]
        env = {"USE_ISTIO": str(cfg.use_istio).lower()}
        if name == "notebook-controller":
            env.update({"ENABLE_CULLING": "false", "CULL_IDLE_TIME": "1440"})
        replicas = 1
        if cfg.ha_controllers:
            # HA control plane: standby replica + Lease leader election
            # (--enable-leader-election parity, control/leases.py)
            env["ENABLE_LEADER_ELECTION"] = "true"
            env["POD_NAMESPACE"] = ns
            replicas = 2
        dep = _deployment(name, ns, img("controller"), args=cmd, env=env,
                          sa="kubeflow-controller")
        dep["spec"]["replicas"] = replicas
        out.append(dep)

    if "poddefault-webhook" in apps:
        # the apiserver only dials webhooks over verified HTTPS
        # (admission-webhook/main.go:541-542). Certs are NOT rendered here:
        # the pod self-bootstraps a CA + serving cert in its emptyDir at
        # startup and patches the live caBundle into this registration
        # (webhook.py publish_ca_bundle) — keys never touch manifests, the
        # state repo, or the operator's machine (README.md:66 leaves
        # caBundle to out-of-band provisioning; ours is in-cluster).
        dep = _deployment(
            "poddefault-webhook", ns, img("controller"),
            args=["python", "-m", MODULES["poddefault-webhook"]],
            env={"WEBHOOK_CERTS_DIR": "/etc/webhook/certs",
                 "POD_NAMESPACE": ns},
            port=4443, sa="kubeflow-controller")
        pod = dep["spec"]["template"]["spec"]
        pod["volumes"] = [{"name": "certs", "emptyDir": {}}]
        pod["containers"][0]["volumeMounts"] = [{
            "name": "certs", "mountPath": "/etc/webhook/certs"}]
        out.append(dep)
        out.append(_service("poddefault-webhook", ns, 443, 4443,
                            scheme="https"))
        hook = ob.new_object(
            "admissionregistration.k8s.io/v1", "MutatingWebhookConfiguration",
            "poddefault-webhook")
        hook["webhooks"] = [{
            "name": "poddefault.kubeflow.org",
            "admissionReviewVersions": ["v1"],
            "sideEffects": "None",
            "clientConfig": {
                "service": {"name": "poddefault-webhook", "namespace": ns,
                            "path": "/apply-poddefault", "port": 443},
                # patched by the pod once its CA exists; empty until then
                "caBundle": "",
            },
            "rules": [{"apiGroups": [""], "apiVersions": ["v1"],
                       "operations": ["CREATE"], "resources": ["pods"]}],
            "failurePolicy": "Ignore",
        }]
        out.append(hook)

    # gateway route prefix per web app — the VirtualServices that make the
    # dashboard's iframe paths (/jupyter/, /tensorboards/) resolve through
    # the platform gateway (reference ships the same per-app VS routing;
    # without it the iframe tabs would 404 against the dashboard origin)
    app_prefixes = {
        "centraldashboard": "/",
        "jupyter-web-app": "/jupyter/",
        "tensorboards-web-app": "/tensorboards/",
    }
    for name, port in SERVICE_PORTS.items():
        if name not in apps:
            continue
        cmd = ["python", "-m", MODULES[name]]
        out.append(_deployment(name, ns, img("platform"), args=cmd, port=port,
                               sa="kubeflow-controller"))
        out.append(_service(name, ns, 80, port))
    routed = {n: p for n, p in app_prefixes.items() if n in apps}
    if cfg.use_istio and routed:
        out.append(_webapps_virtualservice(ns, routed))

    for patch in cfg.overlays:
        _apply_overlay(out, patch)
    return out


def _apply_overlay(objs: list[dict], overlay: dict) -> None:
    """kustomize-style strategic-merge overlay: {target: {kind, name},
    patch: {...}} merged into every matching object."""
    target = overlay.get("target") or {}
    patch = overlay.get("patch") or {}
    for i, o in enumerate(objs):
        if target.get("kind") and o.get("kind") != target["kind"]:
            continue
        if target.get("name") and ob.meta(o).get("name") != target["name"]:
            continue
        objs[i] = ob.merge_patch(o, patch)
