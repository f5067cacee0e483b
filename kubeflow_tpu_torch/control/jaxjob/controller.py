"""JAXJob controller: gang GPU pod sets + torch.distributed bootstrap.

Port of `kubeflow_tpu/control/jaxjob/controller.py`: the reconcile is
the JAX package's line for line — gang creation with rollback, the
condemned sweep, gang restart, preemption by exit 75 (preemptions do not
consume maxRestarts), elastic resize with the world annotation and its
downward-API file, slice health. What differs is what names the
accelerator (`jaxjob/types.py`): pods claim ``nvidia.com/gpu`` and pin
the GPU product and node-pool selectors, run the port's launcher by
default, and a multislice pod gets the port's ``JAXJOB_NUM_SLICES`` /
``JAXJOB_SLICE_ID`` only (no libtpu ``MEGASCALE_*``). Its metrics go to
the port's own ``MetricsRegistry`` (no prometheus_client on the card's
machine) under the JAX package's names.

Reconcile shape mirrors the reference's notebook controller
(notebook_controller.go:85 Reconcile; generate* helpers :282-443), but the
semantics replace what the external tf-operator did for TFJobs:

- render a **headless Service** for stable worker DNS (the TF_CONFIG
  host-list analogue; launcher.py:68-80 decoded that into --ps_hosts/
  --worker_hosts),
- create the **full gang** of worker pods in one reconcile with rollback
  on partial failure — the all-or-nothing semantics the reference never
  had (its replicas restarted independently, create_job_specs.py:136),
- inject `JAXJOB_*` env consumed by parallel.dist.initialize_from_env,
- set `nvidia.com/gpu` limits + GKE GPU node selectors
  (create_job_specs.py:165-170),
- derive status conditions (Created/Running/Restarting/Succeeded/Failed)
  from pod phases, with **gang restart**: any worker failure tears down
  the whole pod set and recreates it (checkpoint-resume picks up from the
  last saved step), up to spec.maxRestarts.
"""

from __future__ import annotations

import logging
import os
import sys

from kubeflow_tpu_torch.control import reconcilehelper as rh
from kubeflow_tpu_torch.control.jaxjob import types as T
from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.runtime import Controller, Reconciler, Request, Result
from kubeflow_tpu_torch.control.scheduler import (
    ANNOTATION_ELASTIC_MIN, ANNOTATION_GANG_SIZE, ANNOTATION_PRIORITY,
    GATE_GANG, LABEL_SPOT, SCHEDULER_NAME,
)
from kubeflow_tpu_torch.control.scheduler.topology import normalize_pool
from kubeflow_tpu_torch.obs import trace as obs_trace
from kubeflow_tpu_torch.parallel import dist as D
from kubeflow_tpu_torch.parallel.dist import WorldSpec
from kubeflow_tpu_torch.runtime.metrics import REGISTRY

log = logging.getLogger("kubeflow_tpu_torch.jaxjob")

# The scheduler's creation -> all-workers-scheduled histogram
# (jaxjob_gang_schedule_seconds), observed at gang bind.
SCHEDULE_LATENCY_BUCKETS = (0.5, 1, 2, 5, 10, 30, 60, 120, 300, 600)


def worker_name(job_name: str, index: int) -> str:
    return f"{job_name}-worker-{index}"


def gang_epoch(job: dict) -> int:
    """The job's current gang incarnation: total restarts of any kind.
    Pods are stamped with the epoch they were created under
    (T.ANNOTATION_EPOCH); an older stamp marks a condemned leftover."""
    status = job.get("status") or {}
    return status.get("restarts", 0) + status.get("preemptions", 0)


def pod_epoch(pod: dict, default: int) -> int:
    """A pod's stamped epoch; unstamped pods (pre-epoch incarnations,
    hand-made test pods) count as current — never condemned by default."""
    try:
        return int(ob.annotations_of(pod).get(T.ANNOTATION_EPOCH, default))
    except (TypeError, ValueError):
        return default


def worker_index(pod_name: str) -> int:
    """Replica index from a worker pod name (ordering key for world
    membership: ranks stay aligned with the original indices). A name
    that does not parse sorts AFTER every real replica — aliasing it to
    index 0 would let a malformed leftover steal the coordinator slot
    in membership ordering and the partial-admission prefix."""
    try:
        return int(pod_name.rsplit("-", 1)[1])
    except (IndexError, ValueError):
        return sys.maxsize


def recreate_indices(pods: list[dict], replicas: int) -> list[int]:
    """Replica slots to re-provision for lost elastic pods. Only real
    slots: a pod whose name does not parse (worker_index's sort
    sentinel) or is out of the gang's range has no slot — it is
    deleted with the shrink, never re-provisioned as a bogus
    '<job>-worker-<sentinel>' pod."""
    idx = (worker_index(ob.meta(p)["name"]) for p in pods)
    return [i for i in idx if i < replicas]


def member_slice(name: str, per_slice: int) -> int:
    """ORIGINAL slice id of a member (contiguous-rank assignment:
    ranks [s*R, (s+1)*R) form slice s — generate_pod's layout). Derived
    from the immutable worker index, so the id survives any shrink:
    a world that lost slice 0 reads slices=(1, 1), never (0, 0)."""
    return worker_index(name) // max(per_slice, 1)


def member_slices(members, spec: dict) -> tuple[int, ...] | None:
    """Per-member slice assignment for a world stamp; None on
    single-slice jobs (their stamp carries no slices)."""
    if spec.get("sliceCount", 1) <= 1:
        return None
    per_slice = spec.get("replicas", 1)
    return tuple(member_slice(n, per_slice) for n in members)


def slice_aligned(names, per_slice: int) -> list[str]:
    """The subset of ``names`` forming COMPLETE slices, ordered by
    worker index. A multislice world only ever resizes in whole
    slices — a partial slice can't hold its shard of the dcn axis."""
    by_slice: dict[int, list[str]] = {}
    for n in names:
        by_slice.setdefault(member_slice(n, per_slice), []).append(n)
    return sorted(
        (n for ns in by_slice.values() if len(ns) == per_slice for n in ns),
        key=worker_index)


def member_coordinator(job: dict, member: str) -> str:
    """Stable DNS of a member's coordinator port (the headless-service
    name scheme the gang's env contract already uses)."""
    m = ob.meta(job)
    port = (job.get("spec") or {}).get(
        "coordinatorPort", T.DEFAULT_COORDINATOR_PORT)
    return f"{member}.{m['name']}.{m['namespace']}.svc:{port}"


def job_world(job: dict) -> WorldSpec:
    """The job's CURRENT elastic world. status.world is the durable
    record a resize writes; absent (fresh job, or after a gang restart
    cleared it) the world is implicitly the full gang."""
    status = job.get("status") or {}
    spec = job.get("spec") or {}
    w = status.get("world")
    if isinstance(w, dict):
        try:
            members = tuple(str(x) for x in w["members"])
            return WorldSpec(gen=int(w["gen"]), size=len(members),
                             members=members,
                             coordinator=w.get("coordinator") or None,
                             slices=member_slices(members, spec))
        except (KeyError, TypeError, ValueError):
            pass  # malformed status residue: fall back to the full gang
    m = ob.meta(job)
    total = T.gang_size(spec)
    members = tuple(worker_name(m["name"], i) for i in range(total))
    return WorldSpec(gen=status.get("resizes", 0), size=total,
                     members=members,
                     coordinator=member_coordinator(job, members[0]),
                     slices=member_slices(members, spec))


class JAXJobReconciler(Reconciler):
    def __init__(self, record_events: bool = True, cache=None,
                 registry=None):
        self.record_events = record_events
        # MetricsRegistry sink for the lifecycle metrics: created and
        # running jobs, and restarts/resizes by namespace (the JAX
        # package also mirrors these into unlabelled prometheus_client
        # families; here the labelled series are the one record)
        self.registry = registry if registry is not None else REGISTRY
        # indexed ClusterCache: pod and node reads come from O(bucket)
        # snapshot indexes instead of per-reconcile list calls. None =
        # the legacy relist shape.
        self.cache = cache
        # open per-job root spans ("JAXJob created" -> gang running),
        # keyed by (namespace, name); their ids are exactly the
        # traceparent stamped into the job + pod annotations, so every
        # scheduler/worker span downstream parents into this root
        self._roots: dict[tuple[str, str], obs_trace.Span] = {}

    # -- trace propagation ---------------------------------------------------

    def _ensure_traceparent(self, client, job: dict) -> dict:
        """Mint the job's trace context on first sight and stamp it into
        the job's annotations (the durable carrier across reconciles and
        controller restarts); open the root span under those exact ids."""
        m = ob.meta(job)
        if (m.get("annotations") or {}).get(obs_trace.TRACEPARENT_ANNOTATION):
            return job
        ctx = obs_trace.SpanContext(
            obs_trace.new_trace_id(), obs_trace.new_span_id())
        # resourceVersion precondition: two workers racing the first
        # reconcile would otherwise BOTH mint a context (last write
        # wins, orphaning one root span). The loser 409s — a benign
        # immediate retry that then sees the winner's annotation.
        job = client.patch(
            T.API_VERSION, T.KIND, m["name"],
            {"metadata": {
                "resourceVersion": m["resourceVersion"],
                "annotations": {
                    obs_trace.TRACEPARENT_ANNOTATION: ctx.to_traceparent()}}},
            m["namespace"])
        self._roots[(m["namespace"], m["name"])] = obs_trace.TRACER.begin(
            "jaxjob", context=ctx, detached=True,
            namespace=m["namespace"], job=m["name"])
        return job

    def _job_context(self, job: dict) -> obs_trace.SpanContext | None:
        return obs_trace.parse_traceparent(
            (ob.meta(job).get("annotations") or {})
            .get(obs_trace.TRACEPARENT_ANNOTATION))

    def _running(self, by: int) -> None:
        """jaxjob_running: JAXJobs currently in the Running condition."""
        self.registry.gauge_add(
            "jaxjob_running", by,
            help_="JAXJobs currently in Running condition")

    def _finish_root(self, namespace: str, name: str, outcome: str) -> None:
        """Close the submit→outcome root span (no-op when this process
        never opened one, e.g. after a controller restart)."""
        root = self._roots.pop((namespace, name), None)
        if root is not None:
            root.attrs["outcome"] = outcome
            obs_trace.TRACER.finish(root)

    # -- generate* ----------------------------------------------------------

    def generate_service(self, job: dict) -> dict:
        """Headless service giving each worker a stable DNS name
        (<pod>.<job>.<ns>.svc); the coordinator address points at index 0."""
        m = ob.meta(job)
        spec = job["spec"]
        svc = ob.new_object(
            "v1",
            "Service",
            m["name"],
            m["namespace"],
            labels={T.LABEL_JOB_NAME: m["name"]},
            spec={
                "clusterIP": "None",
                "selector": {T.LABEL_JOB_NAME: m["name"]},
                "ports": [
                    {
                        "name": "coordinator",
                        "port": spec.get("coordinatorPort", T.DEFAULT_COORDINATOR_PORT),
                    }
                ],
            },
        )
        return svc

    def coordinator_address(self, job: dict) -> str:
        # one spelling of the DNS scheme (member_coordinator): the
        # rigid env coordinator and the elastic world stamp must agree
        return member_coordinator(
            job, worker_name(ob.meta(job)["name"], 0))

    def generate_pod(self, job: dict, index: int) -> dict:
        m = ob.meta(job)
        spec = job["spec"]
        total = T.gang_size(spec)
        per_slice = spec.get("replicas", 1)
        slices = spec.get("sliceCount", 1)
        tmpl = ob.deep_copy(spec.get("template") or {"spec": {"containers": []}})
        pod_spec = tmpl.setdefault("spec", {})
        pod_spec.setdefault("restartPolicy", "Never")
        # stable DNS via the headless service
        pod_spec["hostname"] = worker_name(m["name"], index)
        pod_spec["subdomain"] = m["name"]

        # contiguous-rank slice assignment: ranks [s*R, (s+1)*R) form slice
        # s, matching mesh.py's reshape layout for the `dcn` axis
        slice_id = index // per_slice
        env = [
            {"name": T.ENV_COORD, "value": self.coordinator_address(job)},
            {"name": T.ENV_NPROC, "value": str(total)},
            {"name": T.ENV_PID, "value": str(index)},
            {"name": T.ENV_NAME, "value": m["name"]},
            {"name": T.ENV_NAMESPACE, "value": m["namespace"]},
        ]
        traceparent = (m.get("annotations") or {}).get(
            obs_trace.TRACEPARENT_ANNOTATION)
        if traceparent:
            # end-to-end propagation: the scheduler reads the annotation
            # (its admission spans), the launcher/trainer read the env
            # var (worker + step spans) — all children of the job root
            env.append({"name": obs_trace.TRACEPARENT_ENV,
                        "value": traceparent})
        if slices > 1:
            env += [{"name": k, "value": v} for k, v in sorted(
                D.slice_env(slices, slice_id).items())]
        elastic = T.elastic_spec(spec)
        if elastic:
            # any elastic block (even resizePolicy Restart) opts the
            # worker into spot/preemptible pools: it tolerates reclaim,
            # by restart if not by resize. Rigid gangs never tolerate
            # the spot taint, so on-demand capacity stays theirs.
            tols = list(pod_spec.get("tolerations") or [])
            spot_tol = {"key": LABEL_SPOT, "operator": "Equal",
                        "value": "true", "effect": "NoSchedule"}
            if spot_tol not in tols:
                tols.append(spot_tol)
            pod_spec["tolerations"] = tols
        if T.is_elastic(spec):
            # resize signal plumbing: the world annotation (stamped
            # below, re-stamped on every resize) is projected into the
            # pod via the downward API; the elastic coordinator re-reads
            # the file to catch shrink/grow without a kube client
            env += [
                {"name": T.ENV_WORLD_FILE, "value": T.WORLD_FILE_PATH},
                {"name": T.ENV_BATCH_POLICY,
                 "value": elastic["batchPolicy"]},
            ]
            vols = list(pod_spec.get("volumes") or [])
            if not any(v.get("name") == "jaxjob-world" for v in vols):
                vols.append({"name": "jaxjob-world", "downwardAPI": {
                    "items": [{"path": "world", "fieldRef": {
                        "fieldPath": "metadata.annotations"
                                     f"['{T.ANNOTATION_WORLD}']"}}]}})
            pod_spec["volumes"] = vols
        gpu = spec.get("gpu") or {}
        for c in pod_spec.get("containers", []):
            have = {e["name"] for e in c.get("env", [])}
            c.setdefault("env", []).extend(e for e in env if e["name"] not in have)
            if T.is_elastic(spec):
                mounts = list(c.get("volumeMounts") or [])
                if not any(v.get("name") == "jaxjob-world"
                           for v in mounts):
                    mounts.append({
                        "name": "jaxjob-world",
                        "mountPath": os.path.dirname(T.WORLD_FILE_PATH),
                        "readOnly": True})
                c["volumeMounts"] = mounts
            if gpu.get("gpusPerWorker"):
                res = c.setdefault("resources", {}).setdefault("limits", {})
                res.setdefault(T.RESOURCE_GPU, gpu["gpusPerWorker"])
        if gpu.get("product"):
            sel = pod_spec.setdefault("nodeSelector", {})
            sel.setdefault(T.NODESELECTOR_ACCEL, gpu["product"])
            if slices > 1 and spec.get("schedulerName") == SCHEDULER_NAME:
                # multislice under OUR gang scheduler: the scheduler
                # picks ONE (product, node pool) pool PER SLICE —
                # different slices may land in different pools, so a
                # job-wide pool pin here would overconstrain it. The
                # product selector stays (slices never mix GPU
                # generations); the per-slice pool comes out of
                # admission, not the pod template.
                pass
            elif gpu.get("nodePool"):
                # normalized spelling ("Pool-A" -> "pool-a"): node
                # labels use the canonical form, and selector matching
                # is exact
                try:
                    pool = normalize_pool(gpu["nodePool"])
                except (ValueError, AttributeError):
                    pool = gpu["nodePool"]  # validate() reports this
                sel.setdefault(T.NODESELECTOR_POOL, pool)

        labels = {
            **(tmpl.get("metadata", {}).get("labels") or {}),
            T.LABEL_JOB_NAME: m["name"],
            T.LABEL_REPLICA_INDEX: str(index),
        }
        if slices > 1:
            labels[T.LABEL_SLICE_INDEX] = str(slice_id)
        annotations = dict(tmpl.get("metadata", {}).get("annotations") or {})
        # controller-owned incarnation stamp (a template value must not
        # be able to mark a fresh pod as condemned)
        annotations[T.ANNOTATION_EPOCH] = str(gang_epoch(job))
        if T.is_elastic(spec):
            # controller-owned world stamp: a pod created DURING a
            # shrunken incarnation (a grow-back replacement) carries the
            # current shrunken membership — it is not a member until a
            # grow resize re-stamps it (the worker's join barrier)
            annotations[T.ANNOTATION_WORLD] = job_world(job).to_json()
        if traceparent:
            annotations[obs_trace.TRACEPARENT_ANNOTATION] = traceparent
        if spec.get("schedulerName"):
            pod_spec["schedulerName"] = spec["schedulerName"]
        if spec.get("schedulerName") == SCHEDULER_NAME:
            # OUR gang scheduler: a scheduling gate keeps every kubelet
            # off the pod until the WHOLE gang is bound (all-or-nothing
            # admission), and the annotations carry the gang contract it
            # reads. A foreign schedulerName passes through ungated —
            # only the scheduler that will lift a gate may add one.
            # Appended (not setdefault): a template with its own gates
            # must still get ours, or nothing holds the kubelets off.
            gates = list(pod_spec.get("schedulingGates") or [])
            if not any(g.get("name") == GATE_GANG for g in gates):
                gates.append({"name": GATE_GANG})
            pod_spec["schedulingGates"] = gates
            # the controller OWNS the gang contract: a stale template
            # annotation must not shrink the gang or skew its priority
            annotations[ANNOTATION_GANG_SIZE] = str(total)
            annotations[ANNOTATION_PRIORITY] = str(spec.get("priority", 0))
            if T.is_elastic(spec):
                # partial-admission floor: the scheduler may bind any
                # subset >= this instead of all-or-nothing. For a
                # slice-elastic job the floor is minSlices x replicas
                # (admission is slice-aligned); single-slice elastic
                # keeps minReplicas — elastic_floor spells both.
                annotations[ANNOTATION_ELASTIC_MIN] = str(
                    T.elastic_floor(spec))
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": worker_name(m["name"], index),
                "namespace": m["namespace"],
                "labels": labels,
                "annotations": annotations,
            },
            "spec": pod_spec,
        }
        return pod

    # -- reconcile ----------------------------------------------------------

    def _job_pods(self, client, namespace: str, name: str) -> list[dict]:
        """The gang's pods: O(gang) from the cache's label index, or the
        legacy label-selector list. Cache snapshots are READ-ONLY
        references — this reconciler only reads pods and writes through
        the client, never mutates them in place."""
        if self.cache is not None:
            return self.cache.gang_pods(namespace, name)
        return client.list(
            "v1", "Pod", namespace=namespace,
            label_selector={"matchLabels": {T.LABEL_JOB_NAME: name}},
        )

    # read-your-own-writes over an ASYNC watch (real apiserver): every
    # pod write this reconciler performs folds its response back into
    # the cache immediately, so a reconcile racing the watch delivery
    # can never re-create an existing gang or restart a healthy one
    # from a stale snapshot (the jaxservice/scheduler note_write
    # discipline; rv-guarded, so the watch's later delivery is benign).

    def _note(self, obj) -> None:
        if self.cache is not None and obj:
            self.cache.note_write(obj)

    def _note_gone(self, obj) -> None:
        if self.cache is not None and obj:
            self.cache.note_delete(obj)

    def reconcile(self, client, req: Request) -> Result | None:
        if self.cache is not None:
            self.cache.refresh()
        job = client.get_or_none(T.API_VERSION, T.KIND, req.name, req.namespace)
        if job is None:
            # deleted; ownerRef GC reaps children. Close any still-open
            # root span (a job deleted before Running must not leak it).
            self._finish_root(req.namespace, req.name, "deleted")
            return None
        m = ob.meta(job)
        if m.get("deletionTimestamp"):
            return None

        errs = T.validate(job)
        if errs:
            changed = ob.cond_set(
                job, T.COND_FAILED, "True", "ValidationFailed", "; ".join(errs)
            )
            if changed:
                client.update_status(job)
            self._finish_root(req.namespace, req.name, "validation-failed")
            return None

        if ob.cond_is_true(job, T.COND_SUCCEEDED) or ob.cond_is_true(job, T.COND_FAILED):
            # terminal. Close any straggler root span — every terminal
            # path must export the submit→outcome timeline (a job that
            # went invalid mid-flight, say) rather than leak it open.
            self._finish_root(
                req.namespace, req.name,
                "failed" if ob.cond_is_true(job, T.COND_FAILED)
                else "succeeded")
            return None

        if not ob.cond_get(job, T.COND_CREATED):
            self.registry.counter_inc(
                "jaxjob_create_total",
                help_="JAXJobs seen by the controller")
            job = self._ensure_traceparent(client, job)
            ob.cond_set(job, T.COND_CREATED, "True", "JAXJobCreated",
                        "gang pod set is being provisioned")
            job = client.update_status(job)
            if self.record_events:
                client.record_event(job, "JAXJobCreated", "provisioning gang pod set")

        rh.reconcile_child(client, job, self.generate_service(job))

        spec = job["spec"]
        replicas = T.gang_size(spec)  # total pods across all slices
        pods = self._job_pods(client, req.namespace, req.name)

        # condemned sweep: pods stamped with an OLDER gang epoch are the
        # leftovers of a recorded restart whose teardown was interrupted
        # (a transient apiserver error mid-delete). Finish the teardown
        # and keep them out of status derivation — re-reading a
        # condemned pod's phase as a fresh failure would double-count
        # the restart budget for one incident.
        epoch = gang_epoch(job)
        condemned = [p for p in pods if pod_epoch(p, epoch) < epoch]
        if condemned:
            for p in condemned:
                try:
                    client.delete("v1", "Pod", ob.meta(p)["name"],
                                  req.namespace)
                    self._note_gone(p)
                except ob.NotFound:
                    self._note_gone(p)
                except ob.ApiError:
                    log.exception("condemned-pod delete of %s failed",
                                  ob.meta(p)["name"])
            # their names must free up before the new incarnation can be
            # created — poll again rather than racing the store
            return Result(requeue_after=0.05)
        by_name = {ob.meta(p)["name"]: p for p in pods}

        # gang creation: all pods created in one pass; on partial failure,
        # roll back what we just created and retry the whole gang later.
        missing = [i for i in range(replicas) if worker_name(req.name, i) not in by_name]
        if missing and len(missing) == replicas:
            created: list[dict] = []
            with obs_trace.TRACER.span(
                    "jaxjob.provision", parent=self._job_context(job),
                    namespace=req.namespace, job=req.name,
                    workers=replicas):
                try:
                    for i in missing:
                        pod = self.generate_pod(job, i)
                        ob.set_owner(pod, job)
                        resp = client.create(pod)
                        self._note(resp)
                        created.append(resp)
                except ob.ApiError as e:
                    for p in created:
                        try:
                            client.delete("v1", "Pod", ob.meta(p)["name"], req.namespace)
                            self._note_gone(p)
                        except ob.NotFound:
                            self._note_gone(p)
                        except ob.ApiError:
                            # best-effort rollback: a transient error on
                            # one delete must not strand the rest; the
                            # partial-gang branch below self-heals any
                            # residue on the next reconcile
                            log.exception("rollback delete of %s failed",
                                          ob.meta(p)["name"])
                    if self.record_events:
                        client.record_event(
                            job, "GangCreateFailed",
                            f"could not create full gang of {replicas}: {e}", "Warning",
                        )
                    raise  # retry with backoff
            pods = created
            by_name = {ob.meta(p)["name"]: p for p in pods}
        elif missing:
            if all((p.get("status") or {}).get("phase", "Pending") == "Pending"
                   for p in by_name.values()):
                # the gang is still FORMING — every existing worker is
                # Pending, so no torch.distributed world has started that a
                # late worker could corrupt. Complete the set in place
                # (cheaper than a restart, and burns no restart budget on
                # what was never a running gang — e.g. the residue of a
                # partial create whose rollback also hit a transient error)
                with obs_trace.TRACER.span(
                        "jaxjob.provision", parent=self._job_context(job),
                        namespace=req.namespace, job=req.name,
                        workers=len(missing), completion=True):
                    for i in missing:
                        pod = self.generate_pod(job, i)
                        ob.set_owner(pod, job)
                        p = client.create(pod)
                        self._note(p)
                        by_name[ob.meta(p)["name"]] = p
                pods = list(by_name.values())
            else:
                # a worker vanished from a STARTED gang. Elastic jobs
                # shrink to the survivors (the data-parallel world
                # re-forms at the smaller size, resumes from the last
                # checkpoint — no budget burned); rigid worlds can never
                # re-form a mesh minus one worker, so the whole set
                # restarts.
                handled = False
                if T.is_elastic(spec):
                    missing_names = {worker_name(req.name, i)
                                     for i in missing}
                    if not (missing_names & set(job_world(job).members)) \
                            and (job.get("status") or {}).get("resizes", 0) \
                            >= T.elastic_spec(spec)["maxResizes"]:
                        # only NON-members are missing and the resize
                        # ceiling is spent: they can never rejoin the
                        # world (a grow needs a resize), so their
                        # absence is permanent and harmless — the
                        # shrunken world runs out at its current size
                        handled = True
                    else:
                        res = self._elastic_shrink(
                            client, job, pods,
                            lost=[], recreate=missing,
                            reason="WorkerDisappeared",
                            message=f"workers missing: "
                                    f"{sorted(missing_names)}")
                        if res is not None:
                            return res
                if not handled:
                    return self._gang_restart(
                        client, job, pods, reason="WorkerDisappeared",
                        message=f"workers missing: {[worker_name(req.name, i) for i in missing]}",
                    )

        # -- derive status from pod phases ---------------------------------
        # snapshot for the no-op write guard below: an unchanged status
        # must NOT be re-written — every write bumps the rv and emits a
        # MODIFIED event on our own primary watch, so unconditional
        # keep-fresh writes make the controller its own event storm
        prev_status = ob.deep_copy(job.get("status") or {})
        phases = {
            name: (p.get("status") or {}).get("phase", "Pending")
            for name, p in by_name.items()
        }
        n_succeeded = sum(1 for ph in phases.values() if ph == "Succeeded")
        n_failed = sum(1 for ph in phases.values() if ph == "Failed")
        n_running = sum(1 for ph in phases.values() if ph == "Running")
        job["status"] = job.get("status") or {}
        job["status"]["replicaStatuses"] = {
            "active": n_running,
            "succeeded": n_succeeded,
            "failed": n_failed,
            "pending": replicas - n_running - n_succeeded - n_failed,
        }

        if n_failed > 0:
            return self._maybe_restart_or_fail(client, job, pods, phases)

        complete = n_succeeded == replicas
        leftovers: list[dict] = []
        if not complete and T.is_elastic(spec) and n_succeeded > 0:
            # elastic completion: the CURRENT world's members all
            # succeeded. NON-member pods must not hold the job open —
            # a waiting (or even already-Running, mid-join-barrier)
            # grow-back replacement is deleted below, not re-run: its
            # membership could only come from a grow re-stamp, which
            # can never happen once the members have exited.
            members = set(job_world(job).members)
            if members and all(phases.get(name) == "Succeeded"
                               for name in members):
                complete = True
                leftovers = [p for name, p in by_name.items()
                             if name not in members
                             and phases.get(name) != "Succeeded"]
        if complete:
            was_running = ob.cond_is_true(job, T.COND_RUNNING)
            ob.cond_set(job, T.COND_RUNNING, "False", "JobCompleted", "")
            ob.cond_set(job, T.COND_SUCCEEDED, "True", "AllWorkersSucceeded",
                        f"{n_succeeded}/{replicas} workers succeeded")
            job["status"]["completionTime"] = ob.now_iso()  # status timestamp is apiserver metadata, excluded from decision fingerprints
            client.update_status(job)
            if was_running:
                self._running(-1)
            for p in leftovers:
                try:
                    client.delete("v1", "Pod", ob.meta(p)["name"],
                                  req.namespace)
                    self._note_gone(p)
                except (ob.NotFound, ob.ApiError):
                    pass  # ownerRef GC reaps any residue at job deletion
            if self.record_events:
                client.record_event(job, "JAXJobSucceeded", "all workers succeeded")
            self._finish_root(req.namespace, req.name, "succeeded")
            return None

        # slice health: a node going NotReady (or tainted for impending
        # node maintenance) under a live gang means the mesh is about to
        # break — restart proactively and resume from the checkpoint
        # instead of waiting for pods to crash (SURVEY.md §5 failure
        # detection; no reference precedent). Checked only AFTER the
        # completion branch above: a fully-succeeded gang whose node
        # drains afterwards must stay Succeeded, not be re-run.
        bad_nodes = self._unhealthy_nodes(client, pods)
        if bad_nodes and spec.get("restartPolicy", T.RESTART_GANG) == T.RESTART_GANG:
            # None = rigid gang; a list = the elastic pods to condemn
            # (only the non-terminal pods under the dying nodes — the
            # rest of the data-parallel world keeps training smaller)
            victims = None
            if T.is_elastic(spec):
                victims = [
                    p for p in pods
                    if (p.get("spec") or {}).get("nodeName") in bad_nodes
                    and phases.get(ob.meta(p)["name"]) not in
                    ("Succeeded", "Failed")]
                if victims:
                    res = self._elastic_shrink(
                        client, job, pods,
                        lost=victims,
                        recreate=recreate_indices(victims,
                                                  T.gang_size(spec)),
                        reason="SliceUnhealthy",
                        message=f"unhealthy nodes under gang: {bad_nodes}")
                    if res is not None:
                        return res
            if victims is None or victims:
                # rigid, or an elastic shrink that was not viable
                # (below the floor / ceiling spent): whole-gang restart
                if job["status"].get("preemptions", 0) >= spec.get("maxPreemptions", 50):
                    return self._fail(client, job,
                                      f"unhealthy nodes: {bad_nodes}; "
                                      "preemption budget exhausted")
                return self._gang_restart(
                    client, job, pods, reason="SliceUnhealthy",
                    message=f"unhealthy nodes under gang: {bad_nodes}",
                    preemption=True,
                )
            # elastic with only terminal pods on the dying nodes (a
            # member that already Succeeded): nothing to condemn, the
            # running world is unaffected — neither a resize (which
            # would spuriously shrink the finished member out) nor a
            # restart; completion handles the member's exit

        if T.is_elastic(spec):
            res = self._elastic_world_pass(client, job, by_name, phases)
            if res is not None:
                return res

        if n_running == replicas:
            if not ob.cond_is_true(job, T.COND_RUNNING):
                ob.cond_set(job, T.COND_RUNNING, "True", "AllWorkersRunning",
                            f"{replicas}/{replicas} workers running")
                job["status"].setdefault("startTime", ob.now_iso())  # status timestamp is apiserver metadata, excluded from decision fingerprints
                client.update_status(job)
                self._running(1)
                if self.record_events:
                    client.record_event(job, "JAXJobRunning", "gang is running")
                # the root span's question is "how long from submit to a
                # running gang?" — close it here; worker/step spans keep
                # arriving in the same trace as children of its ids
                self._finish_root(req.namespace, req.name, "running")
            return None

        # still scheduling/pending — keep status fresh, poll again
        if job.get("status") != prev_status:
            client.update_status(job)
        return Result(requeue_after=2.0)

    # -- gang restart -------------------------------------------------------

    @staticmethod
    def _pod_exit_code(pod: dict) -> int | None:
        """Exit code of the MAIN container (spec.containers[0] by
        convention) — a sidecar's exit code must not mask it."""
        statuses = (pod.get("status") or {}).get("containerStatuses") or []
        containers = (pod.get("spec") or {}).get("containers") or []
        main = containers[0].get("name") if containers else None
        for cs in statuses:
            if cs.get("name") != main:
                continue  # a sidecar exiting 75 must not read as preemption
            term = (cs.get("state") or {}).get("terminated") or {}
            if "exitCode" in term:
                return term["exitCode"]
        return None

    @staticmethod
    def _pod_preempted(pod: dict) -> bool:
        """Graceful preemption (main container exited EX_TEMPFAIL) or a
        kubelet eviction (phase Failed, reason Evicted, often with no
        containerStatuses at all — a hard node preemption)."""
        if (pod.get("status") or {}).get("reason") == "Evicted":
            return True
        return JAXJobReconciler._pod_exit_code(pod) == T.EXIT_PREEMPTED

    def _unhealthy_nodes(self, client, pods) -> list[str]:
        """Nodes under gang pods that are NotReady or tainted for
        impending node maintenance. With the cache: zero apiserver
        reads (snapshot lookups). Legacy: one GET per distinct node."""
        names = {(p.get("spec") or {}).get("nodeName") for p in pods}
        names.discard(None)
        if not names:
            return []
        bad: set[str] = set()
        for node_name in names:
            if self.cache is not None:
                # raw cached object, not the NodeView: the legacy check
                # treats a node with NO Ready condition yet as healthy,
                # and that distinction must survive the index rewrite
                node = self.cache.node(node_name)
                if node is None and self.cache.pumped:
                    # a pumped snapshot can lag the Node ADDED on its
                    # independent stream (the pod got here via our own
                    # note_write) — confirm the disappearance against
                    # the apiserver before condemning a healthy gang;
                    # the legacy read below was always authoritative
                    node = client.get_or_none("v1", "Node", node_name)
                    if node is not None:
                        self.cache.note_write(node)
            else:
                node = client.get_or_none("v1", "Node", node_name)
            if node is None:
                bad.add(node_name)
                continue
            conds = (node.get("status") or {}).get("conditions") or []
            ready = next((c for c in conds if c.get("type") == "Ready"), None)
            if ready is not None and ready.get("status") != "True":
                bad.add(node_name)
            elif any(t.get("key") == T.TAINT_IMPENDING_TERMINATION
                     for t in (node.get("spec") or {}).get("taints") or []):
                bad.add(node_name)
        return sorted(bad)

    def _maybe_restart_or_fail(self, client, job, pods, phases) -> Result | None:
        spec = job["spec"]
        failed = [n for n, ph in phases.items() if ph == "Failed"]
        failed_pods = [p for p in pods
                       if phases.get(ob.meta(p)["name"]) == "Failed"]
        gang_policy = spec.get("restartPolicy", T.RESTART_GANG) == T.RESTART_GANG
        # every failure is a preemption (EX_TEMPFAIL or kubelet eviction)
        # => not a crash: the workers were evicted through no fault of
        # the job. Preemptions never consume the maxRestarts crash
        # budget, but a generous maxPreemptions ceiling bounds a
        # pathological always-75 loop.
        preempted = bool(failed_pods) and all(
            self._pod_preempted(p) for p in failed_pods)
        if gang_policy and preempted and T.is_elastic(spec):
            # preemption of an elastic gang: shrink to the survivors
            # instead of tearing everything down — no budget consumed,
            # warm state kept. Falls through to the restart path when
            # the survivors would drop below minReplicas (or the resize
            # ceiling is spent).
            res = self._elastic_shrink(
                client, job, pods,
                lost=failed_pods,
                recreate=recreate_indices(failed_pods,
                                          T.gang_size(spec)),
                reason="WorkerPreempted",
                message=f"preempted workers: {failed}")
            if res is not None:
                return res
        if gang_policy and preempted:
            if job["status"].get("preemptions", 0) < spec.get("maxPreemptions", 50):
                return self._gang_restart(
                    client, job, pods, reason="WorkerPreempted",
                    message=f"preempted workers: {failed}",
                    preemption=True,
                )
            return self._fail(client, job,
                              f"workers preempted: {failed}; "
                              "preemption budget exhausted")
        if gang_policy and \
                job["status"].get("restarts", 0) < spec.get("maxRestarts", 3):
            return self._gang_restart(
                client, job, pods, reason="WorkerFailed",
                message=f"failed workers: {failed}",
            )
        return self._fail(client, job,
                          f"workers failed: {failed}; restarts exhausted")

    # -- elastic resize -----------------------------------------------------

    @staticmethod
    def _gang_gated(pod: dict) -> bool:
        """Still held by OUR scheduling gate — the scheduler has not
        admitted this pod (a grow-back replacement in the queue)."""
        return any(g.get("name") == GATE_GANG for g in
                   (pod.get("spec") or {}).get("schedulingGates") or [])

    def _elastic_shrink(self, client, job, pods, lost, recreate,
                        reason: str, message: str) -> Result | None:
        """Shrink-to-survivors, or None when a shrink is not viable
        (survivors below the elastic floor / resize ceiling spent) —
        the caller then falls back to the restart path.

        Slice-elastic jobs (slicePolicy Shrink) resize at SLICE
        granularity: losing any worker condemns its WHOLE slice (the
        slice's shard of the dcn axis is gone either way), the world
        shrinks to the surviving complete slices, and the floor is
        minSlices x replicas."""
        spec = job["spec"]
        el = T.elastic_spec(spec)
        lost_names = {ob.meta(p)["name"] for p in lost}
        if T.is_slice_elastic(spec):
            per_slice = spec.get("replicas", 1)
            affected = {member_slice(n, per_slice) for n in lost_names}
            affected |= {i // per_slice for i in recreate}
            extra = [p for p in pods
                     if ob.meta(p)["name"] not in lost_names
                     and member_slice(ob.meta(p)["name"], per_slice)
                     in affected
                     and (p.get("status") or {}).get("phase")
                     not in ("Succeeded", "Failed")]
            lost = list(lost) + extra
            lost_names |= {ob.meta(p)["name"] for p in extra}
            # every slot of an affected slice goes back in the grow
            # queue — a slice only ever readmits complete
            recreate = sorted({r for s in affected
                               for r in range(s * per_slice,
                                              (s + 1) * per_slice)}
                              | {i for i in recreate})
        survivors = sorted(
            (ob.meta(p)["name"] for p in pods
             if ob.meta(p)["name"] not in lost_names
             and (p.get("status") or {}).get("phase") == "Running"),
            key=worker_index)
        if T.is_slice_elastic(spec):
            survivors = slice_aligned(survivors, spec.get("replicas", 1))
        if len(survivors) < T.elastic_floor(spec):
            return None
        world = job_world(job)
        if tuple(survivors) != world.members \
                and (job.get("status") or {}).get("resizes", 0) \
                >= el["maxResizes"]:
            return None  # flap ceiling: fall back to restart semantics
        return self._resize(client, job, pods, members=survivors,
                            remove=lost, recreate=recreate,
                            reason=reason, message=message,
                            direction="shrink")

    def _elastic_world_pass(self, client, job, by_name, phases) -> Result | None:
        """Steady-state elastic reconciliation: grow-back when admitted
        replacements came up, shrink-to-admitted when the scheduler
        could only place a subset at start, and the Running condition
        for a healthy shrunken world. None = nothing elastic to do
        (fall through to the rigid-status derivation)."""
        spec = job["spec"]
        el = T.elastic_spec(spec)
        replicas = T.gang_size(spec)
        floor = T.elastic_floor(spec)
        world = job_world(job)
        members = set(world.members)
        running = sorted((n for n, ph in phases.items() if ph == "Running"),
                         key=worker_index)
        if T.is_slice_elastic(spec):
            # a multislice world only resizes in whole slices: a
            # replacement slice joins when ALL its workers are up, and
            # a half-admitted slice never enters the world
            running = slice_aligned(running, spec.get("replicas", 1))
        budget_left = (job.get("status") or {}).get("resizes", 0) \
            < el["maxResizes"]

        newcomers = set(running) - members
        if newcomers and members <= set(running) and budget_left:
            # grow-back: the scheduler readmitted capacity and the
            # replacements are up (in their join barrier, waiting to
            # appear in the world stamp) — re-form at the larger size
            return self._resize(
                client, job, list(by_name.values()), members=running,
                remove=[], recreate=[], reason="CapacityReadmitted",
                message=f"capacity readmitted: {sorted(newcomers)}",
                direction="grow")

        if 0 < len(running) < world.size \
                and len(running) >= floor and budget_left:
            waiting = [n for n in phases if n not in set(running)]
            if all(phases[n] == "Pending" and self._gang_gated(by_name[n])
                   for n in waiting):
                # partial admission at start: every non-running worker
                # is still gate-held (the scheduler bound only a
                # subset >= the elastic floor). Start the world at the
                # admitted size rather than idling bound chips; the
                # remainder grows back on admission.
                return self._resize(
                    client, job, list(by_name.values()), members=running,
                    remove=[], recreate=[], reason="PartialAdmission",
                    message=f"scheduler admitted {len(running)}/{replicas} "
                            f"workers (elastic floor {floor})",
                    direction="shrink")

        if running and tuple(running) == world.members \
                and world.size < replicas:
            # healthy shrunken world: Running at the elastic size. The
            # rigid n_running == replicas branch can never fire here.
            m = ob.meta(job)
            if not ob.cond_is_true(job, T.COND_RUNNING):
                ob.cond_set(job, T.COND_RUNNING, "True", "AllWorkersRunning",
                            f"{world.size}/{replicas} workers running "
                            f"(elastic)")
                job["status"].setdefault("startTime", ob.now_iso())  # status timestamp is apiserver metadata, excluded from decision fingerprints
                client.update_status(job)
                self._running(1)
                if self.record_events:
                    client.record_event(
                        job, "JAXJobRunning",
                        f"elastic gang is running at {world.size}/{replicas}")
                self._finish_root(m["namespace"], m["name"], "running")
            return Result()  # event-driven from here (grow on pod events)
        return None

    def _resize(self, client, job, pods, members, remove, recreate,
                reason: str, message: str, direction: str) -> Result:
        """Record + enact ONE elastic resize. Ordering mirrors
        _gang_restart's record-FIRST discipline: the resize counter,
        activeReplicas and the new world land durably in status before
        any pod is touched — so an interrupted teardown re-enters here,
        sees the membership already recorded, and only FINISHES the pod
        work (idempotent: one incident, one resizes increment).

        ``members`` is the new world (rank = sorted position); ``remove``
        pods are deleted; ``recreate`` indices are re-provisioned as
        fresh pods (gate-held under the gang scheduler), which is
        exactly the grow-back queue."""
        m = ob.meta(job)
        spec = job["spec"]
        members = sorted(members, key=worker_index)
        replicas = T.gang_size(spec)
        world = job_world(job)
        if tuple(members) != world.members:
            status = job["status"] = job.get("status") or {}
            gen = status.get("resizes", 0) + 1
            coordinator = member_coordinator(job, members[0])
            slices = member_slices(members, spec)
            slices_changed = slices is not None and \
                set(slices) != set(world.slices or ())
            world = WorldSpec(gen=gen, size=len(members),
                              members=tuple(members),
                              coordinator=coordinator,
                              slices=slices)
            status["resizes"] = gen
            status["activeReplicas"] = len(members)
            status["world"] = {"gen": gen, "size": len(members),
                               "members": list(members),
                               "coordinator": coordinator}
            if slices is not None:
                status["world"]["slices"] = list(slices)
                status["activeSlices"] = len(set(slices))
            full = len(members) == replicas
            ob.cond_set(job, T.COND_RESIZING,
                        "False" if full else "True", reason,
                        f"{message}; elastic {direction} to "
                        f"{len(members)}/{replicas} (resize #{gen})")
            # a failure HERE leaves status untouched in the store: the
            # retry re-enters from the original membership, still one
            # increment
            client.update_status(job)
            ns = ob.meta(job).get("namespace") or "default"
            self.registry.counter_inc(
                "jaxjob_resizes_total",
                help_="elastic gang resizes "
                      "(shrink-to-survivors / grow-back)",
                namespace=ns, tenant=ns, direction=direction)
            if slices_changed:
                self.registry.counter_inc(
                    "jaxjob_slice_resizes_total",
                    help_="whole-slice elastic resizes (slice-loss "
                          "shrink / slice-readmission grow)",
                    namespace=ns, tenant=ns, direction=direction)
            if self.record_events:
                client.record_event(
                    job,
                    "GangShrunk" if direction == "shrink" else "GangGrown",
                    f"{message}; world is now {len(members)}/{replicas}",
                    "Warning" if direction == "shrink" else "Normal")
        # stamp the new world on every remaining pod: survivors catch
        # the resize through the downward-API projection; waiting
        # replacements see their membership appear on grow (join
        # barrier). Best-effort per pod — re-entry re-stamps stragglers.
        stamp = world.to_json()
        remove_names = {ob.meta(p)["name"] for p in remove}
        for p in pods:
            name = ob.meta(p)["name"]
            if name in remove_names:
                continue
            if ob.annotations_of(p).get(T.ANNOTATION_WORLD) == stamp:
                continue
            try:
                self._note(client.patch(
                    "v1", "Pod", name,
                    {"metadata": {"annotations": {
                        T.ANNOTATION_WORLD: stamp}}},
                    m["namespace"]))
            except ob.NotFound:
                pass
            except ob.ApiError:
                log.exception("resize: world stamp of %s failed", name)
        for p in remove:
            try:
                client.delete("v1", "Pod", ob.meta(p)["name"],
                              m["namespace"])
                self._note_gone(p)
            except ob.NotFound:
                self._note_gone(p)
            except ob.ApiError:
                log.exception("resize: delete of %s failed",
                              ob.meta(p)["name"])
        if (job.get("status") or {}).get("resizes", 0) \
                >= T.elastic_spec(spec)["maxResizes"]:
            # the grow budget is spent: a replacement could never be
            # admitted into the world (the grow re-stamp needs a resize)
            # and would die by join-barrier timeout — a non-75 crash
            # that tears down the healthy shrunken world. Run out the
            # job at the current size instead.
            recreate = []
        have = {ob.meta(p)["name"] for p in pods} - remove_names
        for i in recreate:
            if worker_name(m["name"], i) in have:
                continue
            pod = self.generate_pod(job, i)
            ob.set_owner(pod, job)
            try:
                self._note(client.create(pod))
            except ob.Conflict:
                pass  # old pod name still releasing; re-entry recreates
            except ob.ApiError:
                log.exception("resize: recreate of worker %d failed", i)
        return Result(requeue_after=0.05)

    def _fail(self, client, job, message: str) -> None:
        m = ob.meta(job)
        ob.cond_set(job, T.COND_RUNNING, "False", "JobFailed", "")
        ob.cond_set(job, T.COND_FAILED, "True", "WorkerFailed", message)
        client.update_status(job)
        if self.record_events:
            client.record_event(job, "JAXJobFailed", message, "Warning")
        self._finish_root(m["namespace"], m["name"], "failed")
        return None

    def _gang_restart(self, client, job, pods, reason: str, message: str,
                      preemption: bool = False) -> Result:
        """Delete the whole pod set; next reconcile recreates the gang.
        The gang answer to per-replica restartPolicy: a partially
        restarted torch.distributed world can never re-form, so the
        gang restarts as a unit and resumes from the latest checkpoint.
        preemption=True counts in status.preemptions instead of the
        status.restarts crash budget.

        Ordering is record-FIRST: the counter bump + Restarting
        condition land durably before any pod dies, advancing the gang
        epoch — so however the teardown below is interrupted (a
        transient apiserver error on one delete, a controller crash),
        the next reconcile sees the old incarnation as condemned and
        FINISHES this restart instead of classifying the half-torn-down
        gang as a brand-new incident. One incident, one budget unit."""
        m = ob.meta(job)
        job["status"] = job.get("status") or {}
        counter = "preemptions" if preemption else "restarts"
        job["status"][counter] = job["status"].get(counter, 0) + 1
        if job["status"].pop("world", None) is not None:
            # the shrunken-world record dies with the incarnation: a
            # gang restart re-provisions the FULL gang
            job["status"].pop("activeReplicas", None)
            ob.cond_set(job, T.COND_RESIZING, "False", reason,
                        "gang restart re-provisions the full gang")
        ob.cond_set(job, T.COND_RUNNING, "False", reason, "")
        ob.cond_set(job, T.COND_RESTARTING, "True", reason,
                    f"{message}; gang restart ({counter} "
                    f"#{job['status'][counter]})")
        # a failure HERE leaves status untouched in the store: the retry
        # re-enters from the original counters, still one increment
        client.update_status(job)
        ns = m.get("namespace") or "default"
        self.registry.counter_inc(
            "jaxjob_gang_restart_total",
            help_="gang restarts performed",
            namespace=ns, tenant=ns)
        if self.record_events:
            client.record_event(job, "GangRestart", message, "Warning")
        for p in pods:
            try:
                client.delete("v1", "Pod", ob.meta(p)["name"], m["namespace"])
                self._note_gone(p)
            except ob.NotFound:
                self._note_gone(p)
            except ob.ApiError:
                # best-effort: the condemned sweep reaps survivors
                log.exception("gang restart: delete of %s failed",
                              ob.meta(p)["name"])
        return Result(requeue_after=0.1)


def _node_mapper(client, cache=None):
    """A Node event re-enqueues exactly the JAXJobs with gang pods ON
    that node (slice-health detection): the cache's by-node index, or
    one server-side-filtered pod list (fieldSelector spec.nodeName —
    the same index kube-scheduler and kubelet queries use) instead of
    fanning out to every job in the cluster. O(pods-on-node), the
    right shape for a real cluster."""
    from kubeflow_tpu_torch.control.runtime import Request

    def fn(node: dict) -> list[Request]:
        name = ob.meta(node).get("name")
        if not name:
            return []
        if cache is not None:
            cache.refresh()
            pods = cache.pods_on_node(name)
        else:
            pods = client.list("v1", "Pod",
                               field_selector={"spec.nodeName": name})
        reqs = set()
        for p in pods:
            job = ob.labels_of(p).get(T.LABEL_JOB_NAME)
            if job:
                reqs.add((ob.meta(p).get("namespace") or "default", job))
        return [Request(ns, job) for ns, job in sorted(reqs)]

    return fn


def build_controller(client, record_events: bool = True,
                     registry=None, cache: bool = True) -> Controller:
    """``cache=True`` (default) runs the reconciler's pod/node reads on
    an indexed ``ClusterCache``: one initial list per kind, then zero
    per-reconcile list calls. ``cache=False`` keeps the legacy relist
    shape."""
    cluster_cache = None
    if cache:
        from kubeflow_tpu_torch.control.cache import ClusterCache

        cluster_cache = ClusterCache(client).connect()
    rec = JAXJobReconciler(record_events=record_events, cache=cluster_cache,
                           registry=registry)
    ctl = Controller("jaxjob", client, rec, registry=registry)
    if cluster_cache is not None:
        ctl.uses(cluster_cache)
    ctl.watches_primary(T.API_VERSION, T.KIND).owns("v1", "Pod").owns("v1", "Service")
    ctl.maps("v1", "Node", _node_mapper(client, cache=cluster_cache))
    return ctl
