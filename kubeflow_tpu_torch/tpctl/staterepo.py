"""Deployment-state persistence to a git repo.

Port of `kubeflow_tpu/tpctl/staterepo.py`.

The reference's platform "checkpointing" is pushing the generated app/
config dir to a GCP Cloud Source Repo: clone to a random workdir
(ksServer.go:195-199), write, then add/commit/push with a pull-rebase
retry loop against concurrent writers (ksServer.go:239-267,
sourceRepos.go:188). Same capability here, provider-neutral: any git
remote (Cloud Source Repos, GitHub, a bare repo on NFS) via the git CLI.

What gets persisted per deployment: the TpuDef YAML and the rendered
manifests — enough to re-apply or audit any deployment from the repo
alone (the declarative-config-as-source-of-truth contract).
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import tempfile
import time

log = logging.getLogger("kubeflow_tpu_torch.tpctl.staterepo")

PUSH_RETRIES = 10  # ksServer.go:256 backoff count
RETRY_SLEEP_S = 1.0


class GitError(RuntimeError):
    pass


def _git(args: list[str], cwd: str, check: bool = True,
         ident: tuple[str, str] | None = None) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    if ident:
        # author AND committer: rebase re-commits, so identity must be set
        # for every history-writing command, not just `commit`
        name, email = ident
        env.update(GIT_AUTHOR_NAME=name, GIT_AUTHOR_EMAIL=email,
                   GIT_COMMITTER_NAME=name, GIT_COMMITTER_EMAIL=email)
    p = subprocess.run(["git", *args], cwd=cwd, capture_output=True,
                       text=True, env=env)
    if check and p.returncode != 0:
        raise GitError(f"git {' '.join(args)}: {p.stderr.strip()}")
    return p


class StateRepo:
    """Clone-on-demand writer for a deployment-state git remote."""

    def __init__(self, remote: str, branch: str = "main",
                 author: str = "tpctl <tpctl@kubeflow-tpu>"):
        self.remote = remote
        self.branch = branch
        self.author = author
        name, sep, email = author.partition(" <")
        email = email.rstrip(">")
        if not sep or not name or not email:
            raise ValueError(
                f"author must be 'Name <email>' form, got {author!r} "
                "(git rejects empty idents at commit time)")
        self._ident = (name, email)
        self._dir: str | None = None

    # -- lifecycle ----------------------------------------------------------

    def clone(self) -> str:
        """Fresh clone into a private tempdir (CloneRepoToLocal analogue;
        random dir so concurrent server workers never collide)."""
        if self._dir:
            return self._dir
        d = tempfile.mkdtemp(prefix="tpctl-state-")
        p = _git(["clone", "--branch", self.branch, self.remote, d],
                 cwd="/", check=False)
        if p.returncode != 0:
            # empty remote or missing branch: init and set up the remote
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
            _git(["init", "-b", self.branch], cwd=d)
            _git(["remote", "add", "origin", self.remote], cwd=d)
        self._dir = d
        return d

    def close(self) -> None:
        if self._dir:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def __enter__(self):
        self.clone()
        return self

    def __exit__(self, *exc):
        self.close()

    # -- persistence --------------------------------------------------------

    def save_deployment(self, name: str, tpudef_yaml: str,
                        manifests_yaml: str | None = None,
                        message: str | None = None,
                        sleep=time.sleep) -> str:
        """Write <name>/tpudef.yaml (+ manifests.yaml), commit, push with
        pull-rebase retry (SaveAppToRepo semantics). Returns commit sha."""
        d = self.clone()
        app_dir = os.path.join(d, name)
        os.makedirs(app_dir, exist_ok=True)
        with open(os.path.join(app_dir, "tpudef.yaml"), "w") as f:
            f.write(tpudef_yaml)
        if manifests_yaml is not None:
            with open(os.path.join(app_dir, "manifests.yaml"), "w") as f:
                f.write(manifests_yaml)
        _git(["add", "-A"], cwd=d)
        status = _git(["status", "--porcelain"], cwd=d).stdout.strip()
        if not status:
            log.info("staterepo: %s unchanged; nothing to commit", name)
            return _git(["rev-parse", "HEAD"], cwd=d).stdout.strip()
        _git(["commit", "-m", message or f"tpctl: update {name}"],
             cwd=d, ident=self._ident)

        last_err = ""
        for attempt in range(PUSH_RETRIES):
            p = _git(["push", "origin", self.branch], cwd=d, check=False)
            if p.returncode == 0:
                return _git(["rev-parse", "HEAD"], cwd=d).stdout.strip()
            last_err = p.stderr.strip()
            # concurrent writer won: rebase our commit on theirs and retry
            # (the ksServer.go:245-266 backoff loop)
            _git(["pull", "--rebase", "origin", self.branch], cwd=d,
                 check=False, ident=self._ident)
            sleep(RETRY_SLEEP_S)
        raise GitError(f"push failed after {PUSH_RETRIES} attempts: {last_err}")

    def delete_deployment(self, name: str, sleep=time.sleep) -> bool:
        """Remove <name>/ from the repo (commit+push with the same retry);
        returns False when the deployment wasn't present."""
        d = self.clone()
        _git(["pull", "--rebase", "origin", self.branch], cwd=d,
             check=False, ident=self._ident)
        app_dir = os.path.join(d, name)
        if not os.path.isdir(app_dir):
            return False
        shutil.rmtree(app_dir)
        _git(["add", "-A"], cwd=d)
        _git(["commit", "-m", f"tpctl: delete {name}"], cwd=d,
             ident=self._ident)
        last_err = ""
        for _ in range(PUSH_RETRIES):
            p = _git(["push", "origin", self.branch], cwd=d, check=False)
            if p.returncode == 0:
                return True
            last_err = p.stderr.strip()
            _git(["pull", "--rebase", "origin", self.branch], cwd=d,
                 check=False, ident=self._ident)
            sleep(RETRY_SLEEP_S)
        raise GitError(f"push failed after {PUSH_RETRIES} attempts: {last_err}")

    def load_deployment(self, name: str) -> str:
        """Read back <name>/tpudef.yaml from a fresh clone."""
        d = self.clone()
        _git(["pull", "--rebase", "origin", self.branch], cwd=d, check=False)
        path = os.path.join(d, name, "tpudef.yaml")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no deployment {name!r} in {self.remote}")
        with open(path) as f:
            return f.read()

    def list_deployments(self) -> list[str]:
        d = self.clone()
        _git(["pull", "--rebase", "origin", self.branch], cwd=d, check=False)
        return sorted(
            e for e in os.listdir(d)
            if not e.startswith(".")
            and os.path.isfile(os.path.join(d, e, "tpudef.yaml"))
        )
