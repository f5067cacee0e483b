"""The port's gatekeeper (kubeflow_tpu_torch/control/gatekeeper/) against
the JAX package's.

Under one cookie key and one injected clock the two mint the same
cookie bytes, and each verifies the other's, expiry and tampering
included. Seeded `/auth` checks (basic auth right, wrong and malformed;
cookies fresh, expired, tampered and foreign; browsers and API clients)
and `/login` / `/logout` answer equal statuses, bodies and headers. The
module's main runs as `python -m` and answers over HTTP.
"""

import base64
import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

from kubeflow_tpu.control.gatekeeper import auth as RA
from kubeflow_tpu.utils.httpd import HttpReq as RReq
from kubeflow_tpu_torch.control.gatekeeper import auth as PA
from kubeflow_tpu_torch.utils.httpd import HttpReq as PReq
from test_torch_control_jaxjob import ROOT

KEY = bytes(range(32))
SALT = "pepper"
PASSWORD = "hunter2"


class Clock:
    def __init__(self, t: float = 1_700_000_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def servers(clock, key=KEY, ttl_s=3600):
    common = dict(username="admin", passhash=RA.pwhash(PASSWORD, SALT),
                  salt=SALT, cookie_key=key, ttl_s=ttl_s, clock=clock)
    return PA.AuthServer(**common), RA.AuthServer(**common)


def _req(cls, method, path, headers=None, body=None):
    raw = json.dumps(body).encode() if body is not None else b""
    return cls(method=method, path=path, params={}, query={},
               headers={k.lower(): v for k, v in (headers or {}).items()},
               body=raw)


def _resp(r) -> tuple:
    return r.status, r.body, r.content_type, r.headers


@pytest.mark.parametrize("salt", ["", SALT, "ü-salt"])
def test_pwhash_equal(salt):
    for pw in ("", PASSWORD, "pässwörd", "a" * 100):
        assert PA.pwhash(pw, salt) == RA.pwhash(pw, salt)


@pytest.mark.parametrize("seed", range(4))
def test_cookies_byte_equal_and_cross_verified(seed):
    rng = np.random.default_rng(seed)
    clock = Clock(float(rng.integers(1_600_000_000, 1_800_000_000)))
    port, ref = servers(clock, key=rng.bytes(32),
                        ttl_s=int(rng.integers(60, 86_400)))
    for user in ("admin", "alice@example.com", "x|y", "ü"):
        for now in (None, clock.t - 30.5, clock.t + 7.0):
            got, want = port.mint_cookie(user, now), ref.mint_cookie(user, now)
            assert got == want
            assert port.verify_cookie(want) == ref.verify_cookie(got) == user
        tok = port.mint_cookie(user)
        # at the expiry second itself still valid, one past it not
        exp = int(clock.t + port.ttl_s)
        for at, ok in ((exp, True), (exp + 1, False)):
            assert port.verify_cookie(tok, now=at) == \
                ref.verify_cookie(tok, now=at) == (user if ok else None)
        tampered = tok[:-4] + ("AAAA" if not tok.endswith("AAAA") else "BBBB")
        assert port.verify_cookie(tampered) is None
        assert ref.verify_cookie(tampered) is None
    other_port, other_ref = servers(clock, key=b"\x01" * 32)
    tok = ref.mint_cookie("admin")
    assert other_port.verify_cookie(tok) is other_ref.verify_cookie(tok) \
        is None
    for junk in ("", "not-base64!", base64.urlsafe_b64encode(b"a|b").decode()):
        assert port.verify_cookie(junk) is ref.verify_cookie(junk) is None


def check_headers(rng, clock, tokens) -> dict:
    """One seeded /auth request's headers."""
    h = {}
    kind = int(rng.integers(6))
    if kind == 0:
        h["Authorization"] = "Basic " + base64.b64encode(
            f"admin:{PASSWORD}".encode()).decode()
    elif kind == 1:
        h["Authorization"] = "Basic " + base64.b64encode(
            b"admin:wrong").decode()
    elif kind == 2:
        h["Authorization"] = rng.choice(["Basic !!!", "Bearer abc", "Basic "])
    elif kind == 3:
        h["Cookie"] = f"{PA.COOKIE_NAME}={tokens[int(rng.integers(len(tokens)))]}"
    elif kind == 4:
        h["Cookie"] = f"other=1; {PA.COOKIE_NAME}={tokens[0][:-3]}xyz"
    if rng.random() < 0.5:
        h["Accept"] = rng.choice(["text/html,application/xhtml+xml",
                                  "application/json", "*/*"])
    return h


@pytest.mark.parametrize("seed", range(4))
def test_seeded_checks_equal(seed):
    rng = np.random.default_rng(seed)
    clock = Clock()
    port, ref = servers(clock)
    pr, rr = port.router(), ref.router()
    tokens = [ref.mint_cookie("admin"), ref.mint_cookie("admin", now=0),
              port.mint_cookie("alice@example.com")]
    statuses = []
    for _ in range(60):
        clock.t += float(rng.integers(0, 1200))
        h = check_headers(rng, clock, tokens)
        got = _resp(pr.dispatch(_req(PReq, "GET", "/auth", h)))
        want = _resp(rr.dispatch(_req(RReq, "GET", "/auth", h)))
        assert got == want, h
        statuses.append(got[0])
    assert {200, 302, 401} <= set(statuses)


def test_login_logout_equal():
    clock = Clock()
    port, ref = servers(clock)
    pr, rr = port.router(), ref.router()
    for body in ({"username": "admin", "password": PASSWORD},
                 {"username": "admin", "password": "nope"},
                 {"username": "root", "password": PASSWORD}, {}):
        got = _resp(pr.dispatch(_req(PReq, "POST", "/login", body=body)))
        want = _resp(rr.dispatch(_req(RReq, "POST", "/login", body=body)))
        assert got == want
    cookie = got[3].get("Set-Cookie")
    assert cookie is None
    got = _resp(pr.dispatch(_req(PReq, "POST", "/login", body={
        "username": "admin", "password": PASSWORD})))
    tok = got[3]["Set-Cookie"].split(";")[0]
    # the port's login cookie passes the JAX package's check and back
    h = {"Cookie": tok}
    assert _resp(rr.dispatch(_req(RReq, "GET", "/auth", h)))[0] == 200
    assert _resp(pr.dispatch(_req(PReq, "GET", "/auth", h)))[3] == {
        PA.USER_HEADER: "admin"}
    assert _resp(pr.dispatch(_req(PReq, "POST", "/logout"))) == \
        _resp(rr.dispatch(_req(RReq, "POST", "/logout")))


def test_main_serves_login_and_auth():
    """`python -m kubeflow_tpu_torch.control.gatekeeper --port 0` with its
    credentials from the environment: /healthz, a login over HTTP whose
    cookie passes /auth, 401 without it, and exit 0 on SIGTERM."""
    env = {**os.environ, "GATEKEEPER_USERNAME": "admin",
           "GATEKEEPER_PASSHASH": PA.pwhash(PASSWORD, SALT),
           "GATEKEEPER_SALT": SALT}
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.control.gatekeeper",
         "--port", "0"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("gatekeeper on :"), (line, proc.stderr.read())
        base = f"http://127.0.0.1:{int(line.split(':')[-1])}"
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.status == 200
        req = urllib.request.Request(
            base + "/login", method="POST", data=json.dumps(
                {"username": "admin", "password": PASSWORD}).encode())
        with urllib.request.urlopen(req, timeout=10) as r:
            cookie = r.headers["Set-Cookie"].split(";")[0]
        req = urllib.request.Request(base + "/auth",
                                     headers={"Cookie": cookie})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
            assert r.headers[PA.USER_HEADER] == "admin"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/auth", timeout=10)
        assert e.value.code == 401
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
