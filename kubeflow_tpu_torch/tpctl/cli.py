"""tpctl CLI — the kfctl/kfctlClient command surface.

Port of `kubeflow_tpu/tpctl/cli.py`, its YAML through the port's
`utils/yaml_lite`: `python -m kubeflow_tpu_torch.tpctl.cli ...`.

`tpctl generate|apply|delete|status` against a kubeconfig-reachable
cluster (or `--dry-run` to print). Mirrors the client flow of
bootstrap/cmd/kfctlClient/main.go:141 (run :59) without the HTTP hop:
the coordinator runs in-process; `tpctl server` starts the REST plane
(router/kfctlServer pattern) instead.
"""

from __future__ import annotations

import argparse
import json
import sys

from kubeflow_tpu_torch.tpctl.apply import Coordinator
from kubeflow_tpu_torch.tpctl.tpudef import TpuDef, example_yaml
from kubeflow_tpu_torch.utils import yaml_lite


def _client(args):
    if args.dry_run:
        from kubeflow_tpu_torch.control.k8s.fake import FakeCluster

        return FakeCluster()
    from kubeflow_tpu_torch.control.k8s.rest import RestClient

    return RestClient(base_url=args.server or None)


def _push_state(args, cfg: TpuDef) -> None:
    """Persist the applied TpuDef + rendered manifests to --state-repo
    (no-op without the flag or on --dry-run)."""
    if not args.state_repo or args.dry_run:
        if args.state_repo:
            print(f"dry-run: not pushing state to {args.state_repo}",
                  file=sys.stderr)
        return
    from kubeflow_tpu_torch.tpctl import manifests
    from kubeflow_tpu_torch.tpctl.staterepo import StateRepo

    with StateRepo(args.state_repo, branch=args.state_branch) as repo:
        sha = repo.save_deployment(
            cfg.name, cfg.dump(),
            manifests_yaml=yaml_lite.dump_all(manifests.render(cfg)))
    print(f"state pushed to {args.state_repo} @ {sha[:12]}")


def doctor_report(client, cfg: TpuDef) -> tuple[list[dict], bool]:
    """Per-component readiness report: for every object the manifest set
    renders, check presence — and for Deployments, readiness (the
    hermetic wait_for_kubeflow.py / kf_is_ready_test.py contract:
    kf_is_ready asserts Deployments ready per platform)."""
    from kubeflow_tpu_torch.control.k8s import objects as ob
    from kubeflow_tpu_torch.tpctl import manifests

    rows: list[dict] = []
    healthy = True
    for obj in manifests.render(cfg):
        kind = obj.get("kind")
        m = ob.meta(obj)
        ns = m.get("namespace")
        live = client.get_or_none(obj["apiVersion"], kind, m["name"], ns)
        row = {"kind": kind, "name": m["name"], "ok": True, "status": "ok"}
        if live is None:
            row.update(ok=False, status="missing")
        elif kind == "Deployment":
            want = (obj.get("spec") or {}).get("replicas", 1)
            got = (live.get("status") or {}).get("readyReplicas", 0)
            if got < want:
                row.update(ok=False, status="not-ready",
                           detail=f"{got}/{want} replicas ready")
        if not row["ok"]:
            healthy = False
        rows.append(row)
    return rows, healthy


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("tpctl", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    for name in ("apply", "delete", "status", "generate", "doctor"):
        sp = sub.add_parser(name)
        if name != "status":
            sp.add_argument("-f", "--file", help="TpuDef YAML (default: example)")
        else:
            sp.add_argument("name", nargs="?", default="kubeflow-tpu")
        sp.add_argument("--server", default="", help="apiserver URL (default: in-cluster)")
        sp.add_argument("--dry-run", action="store_true",
                        help="apply against an in-memory cluster and print")
        sp.add_argument("--state-repo", default="",
                        help="git remote to persist/read deployment state "
                             "(ksServer SaveAppToRepo analogue)")
        sp.add_argument("--state-branch", default="main")
        sp.add_argument("--url", default="",
                        help="tpctl server URL: go through the REST plane "
                             "(kfctlClient flow) instead of applying "
                             "in-process")

    sps = sub.add_parser("server", help="REST deployment plane")
    sps.add_argument("--port", type=int, default=8080)
    sps.add_argument("--mode", default="router", choices=("router", "worker"))
    sps.add_argument("--dry-run", action="store_true")
    sps.add_argument("--server", default="")
    sps.add_argument("--isolation", default="thread",
                     choices=("thread", "subprocess"),
                     help="subprocess: each deployment's applies run in a "
                          "child tpctl process (router.go:275 StatefulSet-"
                          "per-deployment isolation); requires --server")
    sps.add_argument("--cloud-auth-gate", action="store_true",
                     help="require a bearer token with setIamPolicy on the "
                          "target project for cloud-platform deployments "
                          "(validated against cloudresourcemanager)")
    sps.add_argument("--crm-endpoint",
                     default="https://cloudresourcemanager.googleapis.com/v1",
                     help="cloudresourcemanager endpoint (private-access "
                          "VPCs / tests)")

    spe = sub.add_parser("example", help="print an example TpuDef")

    args = p.parse_args(argv)

    if args.cmd == "example":
        print(example_yaml(), end="")
        return 0

    if args.cmd == "server":
        from kubeflow_tpu_torch.tpctl.server import TpctlServer

        crm = None
        if args.cloud_auth_gate:
            from kubeflow_tpu_torch.tpctl.cloudauth import HttpCrmBackend

            crm = HttpCrmBackend(endpoint=args.crm_endpoint)
        if args.isolation == "subprocess" and not args.server:
            p.error("--isolation subprocess requires --server (the child "
                    "tpctl processes dial the apiserver directly)")
        if args.isolation == "subprocess" and args.dry_run:
            # child applies would mutate the REAL apiserver while the
            # server's own status reads hit the in-memory fake
            p.error("--isolation subprocess and --dry-run are mutually "
                    "exclusive")
        srv = TpctlServer(_client(args), crm_backend=crm,
                          isolation=args.isolation,
                          apiserver_url=args.server)
        svc = srv.serve(port=args.port)
        print(f"tpctl server listening on :{svc.port}")
        try:
            svc._server.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0

    # --url validation FIRST: every non-apply subcommand must reject it
    # rather than silently fall through to the in-process path against a
    # possibly different cluster.
    if getattr(args, "url", "") and args.cmd != "apply":
        p.error("--url is only supported with 'apply'")
    if getattr(args, "url", "") and getattr(args, "dry_run", False):
        p.error("--url and --dry-run are mutually exclusive (the "
                "server would perform a real deployment)")

    if args.cmd == "status":
        coord = Coordinator(_client(args))
        obj = coord.status(args.name)
        if obj is None:
            print(f"TpuDef {args.name} not found", file=sys.stderr)
            return 1
        print(json.dumps(obj.get("status", {}), indent=2))
        return 0

    if args.cmd == "doctor":
        cfg = (TpuDef.load(args.file) if getattr(args, "file", None)
               else TpuDef.from_dict(yaml_lite.loads(example_yaml())))
        rows, healthy = doctor_report(_client(args), cfg)
        for r in rows:
            mark = "ok " if r["ok"] else "MISSING" if r["status"] == "missing" \
                else "NOT-READY"
            print(f"{mark:9s} {r['kind']:32s} {r['name']}"
                  + (f"  ({r['detail']})" if r.get("detail") else ""))
        print("platform healthy" if healthy else "platform NOT healthy")
        return 0 if healthy else 1

    cfg = (TpuDef.load(args.file) if getattr(args, "file", None)
           else TpuDef.from_dict(yaml_lite.loads(example_yaml())))

    if args.cmd == "generate":
        from kubeflow_tpu_torch.tpctl import manifests

        print(yaml_lite.dump_all(manifests.render(cfg)), end="")
        return 0

    if getattr(args, "url", ""):
        from kubeflow_tpu_torch.tpctl.client import TpctlClient

        client = TpctlClient(args.url)
        if not client.check_access():
            print(f"cannot reach tpctl server at {args.url}", file=sys.stderr)
            return 1
        status = client.apply_and_wait(cfg)
        print(f"applied {cfg.name} via {args.url}: "
              f"{ {c['type']: c['status'] for c in status['conditions']} }")
        _push_state(args, cfg)
        return 0

    coord = Coordinator(_client(args))
    if args.cmd == "apply":
        obj = coord.apply(cfg)
        conds = {c["type"]: c["status"]
                 for c in (obj.get("status") or {}).get("conditions", [])}
        print(f"applied {cfg.name}: {conds}")
        _push_state(args, cfg)
        return 0
    if args.cmd == "delete":
        coord.delete(cfg)
        print(f"deleted {cfg.name}")
        if args.state_repo and not args.dry_run:
            from kubeflow_tpu_torch.tpctl.staterepo import StateRepo

            with StateRepo(args.state_repo, branch=args.state_branch) as repo:
                if repo.delete_deployment(cfg.name):
                    print(f"state removed from {args.state_repo}")
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
