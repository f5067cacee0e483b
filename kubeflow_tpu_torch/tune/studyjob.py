"""StudyJob controller: HPO sweeps where every trial is a JAXJob.

Port of `kubeflow_tpu/tune/studyjob.py`: the same sweeps, suggestions and
status over the port's control plane. A trial is the port's JAXJob, so
its pods claim ``nvidia.com/gpu`` and run the port's launcher; the
default trial template runs ``python -m
kubeflow_tpu_torch.runtime.launcher`` on the port's image
(``DEFAULT_IMAGE``), which the JAX package's reaches through its jaxrt
image's entrypoint. The launcher takes no hyperparameter flags: a
sweep's template substitutes its ``${param}`` tokens into what the
trial runs, e.g. a ``--config`` path written for each value.

Contract preserved from the reference's consumer
(testing/katib_studyjob_test.py): `status.conditions[].type` reaches
"Running" while trials execute and "Succeeded"/"Failed" terminally; the
E2E polls exactly that (:128-194). Spec shape follows the katib
v1alpha1 StudyJob the test submits: objective + parameter space +
suggestion algorithm + trial template.

Search algorithms: grid and random (the two the reference example used),
plus the two the katib of that era shipped beyond them: bayesian
optimization (here a TPE-flavored exploit/explore sampler over completed
trials — no GP dependency) and hyperband-style successive halving
(budget rungs with top-1/eta promotion; the trial template receives the
rung budget through ``${budget}``).
Trial metrics: trials publish their objective through the
``studyjob.kubeflow.org/objective-value`` annotation on their JAXJob
(written by a collector from the trial's summary line, or by the test);
the collector is injectable, so other transports plug in.
"""

from __future__ import annotations

import itertools
import json
import logging
import random as _random
from typing import Any, Callable

from kubeflow_tpu_torch.control.jaxjob import types as JT
from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.runtime import Controller, Reconciler, Request, Result

log = logging.getLogger("kubeflow_tpu_torch.studyjob")

GROUP = "kubeflow.org"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"
KIND = "StudyJob"

ANNO_OBJECTIVE = "studyjob.kubeflow.org/objective-value"
ANNO_PARAMETERS = "studyjob.kubeflow.org/parameters"
LABEL_STUDY = "studyjob.kubeflow.org/study-name"
LABEL_TRIAL = "studyjob.kubeflow.org/trial-id"

COND_RUNNING = "Running"
COND_SUCCEEDED = "Succeeded"
COND_FAILED = "Failed"


def new_studyjob(
    name: str,
    namespace: str = "default",
    *,
    objective: str = "loss",
    goal: str = "minimize",
    algorithm: str = "grid",
    parameters: list[dict] | None = None,
    trial_template: dict | None = None,
    max_trials: int = 4,
    parallel_trials: int = 2,
    seed: int = 0,
) -> dict:
    return ob.new_object(
        API_VERSION, KIND, name, namespace,
        spec={
            "objective": {"objectiveMetricName": objective, "type": goal},
            "algorithm": {"algorithmName": algorithm, "seed": seed},
            "parameters": parameters or [],
            "trialTemplate": trial_template or {},
            "maxTrialCount": max_trials,
            "parallelTrialCount": parallel_trials,
        },
    )


def crd_manifest() -> dict:
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"studyjobs.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {"kind": KIND, "listKind": "StudyJobList",
                      "plural": "studyjobs", "singular": "studyjob"},
            "scope": "Namespaced",
            "versions": [{
                "name": VERSION, "served": True, "storage": True,
                "subresources": {"status": {}},
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "x-kubernetes-preserve-unknown-fields": True}},
            }],
        },
    }


# ---------------------------------------------------------------------------
# suggestion algorithms


def _param_values(p: dict) -> list[Any]:
    ptype = p.get("parameterType", p.get("type", "categorical"))
    feas = p.get("feasible") or {}
    if ptype in ("categorical", "discrete"):
        return list(feas.get("list") or p.get("list") or [])
    lo, hi = float(feas.get("min", 0)), float(feas.get("max", 1))
    steps = int(feas.get("steps", 3))
    if ptype == "int":
        vals = sorted({round(lo + (hi - lo) * i / max(steps - 1, 1))
                       for i in range(steps)})
        return [int(v) for v in vals]
    return [lo + (hi - lo) * i / max(steps - 1, 1) for i in range(steps)]


def grid_suggestions(parameters: list[dict], max_trials: int) -> list[dict]:
    names = [p["name"] for p in parameters]
    spaces = [_param_values(p) for p in parameters]
    combos = itertools.product(*spaces) if spaces else iter([()])
    return [dict(zip(names, c)) for c in itertools.islice(combos, max_trials)]


def random_suggestions(parameters: list[dict], max_trials: int, seed: int = 0) -> list[dict]:
    rng = _random.Random(seed)
    out = []
    for _ in range(max_trials):
        pick = {}
        for p in parameters:
            ptype = p.get("parameterType", p.get("type", "categorical"))
            feas = p.get("feasible") or {}
            if ptype in ("categorical", "discrete"):
                pick[p["name"]] = rng.choice(list(feas.get("list") or p.get("list")))
            elif ptype == "int":
                pick[p["name"]] = rng.randint(int(feas.get("min", 0)),
                                              int(feas.get("max", 1)))
            else:
                pick[p["name"]] = rng.uniform(float(feas.get("min", 0.0)),
                                              float(feas.get("max", 1.0)))
        out.append(pick)
    return out


def bayes_suggestions(parameters: list[dict], max_trials: int, seed: int,
                      observations: list[dict] | None = None,
                      goal: str = "minimize") -> list[dict]:
    """Sequential model-based search, TPE-flavored: the first quarter of
    the budget explores uniformly; afterwards each suggestion either
    perturbs a random top-quartile observed config (exploit, sigma =
    1/8 of the range, decaying with trial index) or samples uniformly
    (explore, 20%). Launched trials pin their params in an annotation,
    so re-deriving the tail as observations arrive is safe."""
    out = random_suggestions(parameters, max_trials, seed)
    obs = [o for o in (observations or []) if o.get("objective") is not None]
    if len(obs) < 2:
        return out
    obs = sorted(obs, key=lambda o: o["objective"],
                 reverse=(goal == "maximize"))
    top = [o["parameters"] for o in obs[:max(1, len(obs) // 4)]]
    n_init = max(2, max_trials // 4)
    for i in range(max(n_init, len(obs)), max_trials):
        rng_i = _random.Random((seed, i, len(obs)).__hash__())
        if rng_i.random() < 0.2:
            continue  # keep the uniform-explore sample from the skeleton
        base = rng_i.choice(top)
        pick = {}
        for p in parameters:
            name = p["name"]
            ptype = p.get("parameterType", p.get("type", "categorical"))
            feas = p.get("feasible") or {}
            anchor = base.get(name)
            if ptype in ("categorical", "discrete"):
                choices = list(feas.get("list") or p.get("list"))
                pick[name] = anchor if (anchor in choices
                                        and rng_i.random() < 0.8) \
                    else rng_i.choice(choices)
                continue
            lo, hi = float(feas.get("min", 0.0)), float(feas.get("max", 1.0))
            sigma = (hi - lo) / 8.0 / (1.0 + i / max(max_trials, 1))
            try:
                center = float(anchor)
            except (TypeError, ValueError):
                center = (lo + hi) / 2
            val = min(hi, max(lo, rng_i.gauss(center, sigma)))
            pick[name] = int(round(val)) if ptype == "int" else val
        out[i] = pick
    return out


def sha_rungs(algo: dict) -> tuple[list[int], int]:
    """Budget ladder for successive halving: minBudget * eta^r up to
    maxBudget; returns (rungs, eta)."""
    eta = max(2, int(algo.get("reduction", 2)))
    bmin = max(1, int(algo.get("minBudget", 1)))
    bmax = max(bmin, int(algo.get("maxBudget", bmin * eta ** 2)))
    rungs = [bmin]
    while rungs[-1] * eta <= bmax:
        rungs.append(rungs[-1] * eta)
    return rungs, eta


def sha_bracket(max_trials: int, rungs: list[int], eta: int) -> int:
    """Initial rung size n0 so the WHOLE bracket (rung r runs
    max(1, n0 // eta^r) trials — the promotion rule below) stays within
    maxTrialCount: katib's cap is total trials, not initial configs."""
    for n0 in range(max(1, max_trials), 1, -1):
        total, n = 0, n0
        for _ in rungs:
            total += n
            n = max(1, n // eta)
        if total <= max_trials:
            return n0
    return 1


def sha_suggestions(parameters: list[dict], max_trials: int, seed: int,
                    observations: list[dict] | None = None,
                    goal: str = "minimize",
                    algo: dict | None = None) -> list[dict]:
    """Hyperband-style successive halving (single bracket): the largest
    n0 whose full bracket fits maxTrialCount runs at the smallest
    budget; when a rung completes, the top 1/eta configs re-run at
    eta x the budget. Every suggestion carries a ``budget`` param for
    the trial template's ``${budget}`` token."""
    rungs, eta = sha_rungs(algo or {})
    # a ladder longer than the trial budget can't fit even at n0=1 (one
    # trial per rung): drop the top rungs so the cap always holds
    rungs = rungs[:max(1, max_trials)]
    n0 = sha_bracket(max_trials, rungs, eta)
    out = [dict(c, budget=rungs[0])
           for c in random_suggestions(parameters, n0, seed)]
    for r in range(1, len(rungs)):
        prev_budget = rungs[r - 1]
        expected = len([s for s in out if s["budget"] == prev_budget])
        done_prev = [o for o in (observations or [])
                     if int(o["parameters"].get("budget", -1)) == prev_budget]
        if len(done_prev) < expected:
            break  # rung still running; promotions appear when it drains
        # failed / metric-less trials count toward the drain above but are
        # never promoted: promote the top 1/eta of the *survivors*
        survivors = [o for o in done_prev if o.get("objective") is not None]
        keep = min(max(1, expected // eta), len(survivors))
        survivors.sort(key=lambda o: o["objective"],
                       reverse=(goal == "maximize"))
        for o in survivors[:keep]:
            cfg = {k: v for k, v in o["parameters"].items() if k != "budget"}
            out.append(dict(cfg, budget=rungs[r]))
    return out


def _substitute(obj: Any, params: dict) -> Any:
    """${param} substitution in the trial template (katib's
    go-template analogue). Full-string matches keep native types."""
    if isinstance(obj, dict):
        return {k: _substitute(v, params) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_substitute(v, params) for v in obj]
    if isinstance(obj, str):
        for k, v in params.items():
            token = "${" + k + "}"
            if obj == token:
                return v
            if token in obj:
                obj = obj.replace(token, str(v))
        return obj
    return obj


def default_collector(job: dict) -> float | None:
    """Read the objective off the trial JAXJob's annotation."""
    val = ob.annotations_of(job).get(ANNO_OBJECTIVE)
    if val is None:
        return None
    try:
        return float(val)
    except ValueError:
        return None


class StudyJobReconciler(Reconciler):
    def __init__(self, collector: Callable[[dict], float | None] = default_collector):
        self.collector = collector

    def _suggestions(self, study: dict,
                     observations: list[dict] | None = None) -> list[dict]:
        spec = study["spec"]
        algo_spec = spec.get("algorithm") or {}
        algo = algo_spec.get("algorithmName", "grid")
        max_trials = spec.get("maxTrialCount", 4)
        params = spec.get("parameters") or []
        seed = algo_spec.get("seed", 0)
        goal = (spec.get("objective") or {}).get("type", "minimize")
        if algo == "random":
            return random_suggestions(params, max_trials, seed)
        if algo == "grid":
            return grid_suggestions(params, max_trials)
        if algo in ("bayesianoptimization", "bayes"):
            return bayes_suggestions(params, max_trials, seed,
                                     observations, goal)
        if algo in ("hyperband", "successivehalving"):
            return sha_suggestions(params, max_trials, seed,
                                   observations, goal, algo_spec)
        raise ValueError(f"unknown algorithmName {algo!r} "
                         "(grid|random|bayesianoptimization|hyperband)")

    def trial_name(self, study: dict, idx: int) -> str:
        return f"{ob.meta(study)['name']}-trial-{idx}"

    def generate_trial(self, study: dict, idx: int, params: dict) -> dict:
        m = ob.meta(study)
        tmpl = ob.deep_copy((study["spec"].get("trialTemplate") or {}))
        tmpl = _substitute(tmpl, params)
        job = {
            "apiVersion": JT.API_VERSION,
            "kind": JT.KIND,
            "metadata": {
                "name": self.trial_name(study, idx),
                "namespace": m["namespace"],
                "labels": {LABEL_STUDY: m["name"], LABEL_TRIAL: str(idx)},
                "annotations": {
                    ANNO_PARAMETERS: json.dumps(params)},
            },
            "spec": tmpl.get("spec", tmpl) or {
                "replicas": 1,
                "template": {"spec": {"containers": [
                    {"name": "jax", "image": JT.DEFAULT_IMAGE,
                     "command": list(JT.DEFAULT_COMMAND)}]}},
            },
        }
        return job

    def reconcile(self, client, req: Request) -> Result | None:
        study = client.get_or_none(API_VERSION, KIND, req.name, req.namespace)
        if study is None or ob.meta(study).get("deletionTimestamp"):
            return None
        if ob.cond_is_true(study, COND_SUCCEEDED) or ob.cond_is_true(study, COND_FAILED):
            return None

        spec = study["spec"]
        parallel = spec.get("parallelTrialCount", 2)

        trials = client.list(
            JT.API_VERSION, JT.KIND, namespace=req.namespace,
            label_selector={"matchLabels": {LABEL_STUDY: req.name}},
        )
        by_idx = {int(ob.labels_of(t)[LABEL_TRIAL]): t for t in trials}

        n_done = n_failed = n_active = 0
        results: list[dict] = []
        for idx, t in by_idx.items():
            succeeded = ob.cond_is_true(t, JT.COND_SUCCEEDED)
            if succeeded or ob.cond_is_true(t, JT.COND_FAILED):
                # failed trials observe objective None: they count toward
                # rung drain in successive halving but are never promoted
                n_done, n_failed = n_done + succeeded, n_failed + (not succeeded)
                results.append({
                    "trial": ob.meta(t)["name"],
                    "parameters": json.loads(
                        ob.annotations_of(t).get(ANNO_PARAMETERS, "{}")),
                    "objective": self.collector(t) if succeeded else None,
                })
            else:
                n_active += 1

        # sequential algorithms (bayes, successive halving) grow/refine the
        # suggestion list from completed-trial observations
        try:
            suggestions = self._suggestions(study, results)
        except ValueError as e:
            ob.cond_set(study, COND_FAILED, "True", "BadAlgorithm", str(e))
            client.update_status(study)
            return None

        # launch next trials up to parallelism
        next_idx = max(by_idx) + 1 if by_idx else 0
        while n_active < parallel and next_idx < len(suggestions):
            trial = self.generate_trial(study, next_idx, suggestions[next_idx])
            ob.set_owner(trial, study)
            client.create(trial)
            n_active += 1
            next_idx += 1

        status = study.setdefault("status", {})
        status["trials"] = {"completed": n_done, "failed": n_failed,
                            "active": n_active, "total": len(suggestions)}
        done = n_done + n_failed >= len(suggestions) and n_active == 0

        # best trial so far (objective direction from spec)
        goal = (spec.get("objective") or {}).get("type", "minimize")
        scored = [r for r in results if r["objective"] is not None]
        if scored:
            best = (min if goal == "minimize" else max)(
                scored, key=lambda r: r["objective"])
            status["bestTrial"] = best

        if done:
            ob.cond_set(study, COND_RUNNING, "False", "SweepComplete", "")
            if n_done > 0:
                ob.cond_set(study, COND_SUCCEEDED, "True", "SweepComplete",
                            f"{n_done}/{len(suggestions)} trials succeeded")
            else:
                ob.cond_set(study, COND_FAILED, "True", "AllTrialsFailed",
                            f"{n_failed} trials failed")
            client.update_status(study)
            return None

        ob.cond_set(study, COND_RUNNING, "True", "TrialsRunning",
                    f"{n_active} active / {n_done} done")
        client.update_status(study)
        return Result(requeue_after=2.0)


def build_controller(client, collector=default_collector) -> Controller:
    rec = StudyJobReconciler(collector=collector)
    ctl = Controller("studyjob", client, rec)
    ctl.watches_primary(API_VERSION, KIND).owns(JT.API_VERSION, JT.KIND)
    return ctl
