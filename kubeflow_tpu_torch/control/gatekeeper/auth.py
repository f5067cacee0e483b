"""Basic-auth "authservice": the Istio ext-authz check endpoint.

Mirrors gatekeeper/auth/AuthServer.go:
- ServeHTTP (:62): allow when basic-auth matches (authpwd :118) or a
  valid session cookie is presented (authCookie :143); otherwise 302 to
  the login page (redirectToLogin :161) for browser clients and 401 for
  API clients.
- Cookie minting on successful login (:183).

Password hashing: SHA-256 (the reference stores a passhash + salt via
its kflogin config). On allow, the identity is propagated in the
``kubeflow-userid`` header — the attach_user_middleware contract the
dashboard and KFAM consume.

Port of `kubeflow_tpu/control/gatekeeper/auth.py`: the same hash,
cookie bytes (HMAC-SHA256 over ``user|expiry``, urlsafe base64), checks
and responses, so a cookie one package mints the other verifies under
the same key.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import logging
import os
import secrets
import time

from kubeflow_tpu_torch.utils import httpd
from kubeflow_tpu_torch.utils.httpd import HttpReq, HttpResp, Router

log = logging.getLogger("kubeflow_tpu_torch.gatekeeper")

COOKIE_NAME = "kubeflow-auth"
USER_HEADER = "kubeflow-userid"
DEFAULT_TTL_S = 24 * 3600


def pwhash(password: str, salt: str = "") -> str:
    return hashlib.sha256((salt + password).encode()).hexdigest()


class AuthServer:
    def __init__(
        self,
        username: str | None = None,
        passhash: str | None = None,
        salt: str = "",
        login_url: str = "/kflogin",
        cookie_key: bytes | None = None,
        ttl_s: int = DEFAULT_TTL_S,
        clock=time.time,
    ):
        self.username = username or os.environ.get("GATEKEEPER_USERNAME", "admin")
        self.passhash = passhash or os.environ.get("GATEKEEPER_PASSHASH", "")
        self.salt = salt or os.environ.get("GATEKEEPER_SALT", "")
        self.login_url = login_url
        self.cookie_key = cookie_key or secrets.token_bytes(32)
        self.ttl_s = ttl_s
        # one clock for every expiry decision: mint and verify read the
        # same injectable source, so tests (and replays) drive token
        # lifecycles without monkey-patching time.time
        self.clock = clock

    # -- cookie minting/verification (:143-199) -----------------------------

    def mint_cookie(self, user: str, now: float | None = None) -> str:
        exp = int((self.clock() if now is None else now) + self.ttl_s)
        payload = f"{user}|{exp}"
        sig = hmac.new(self.cookie_key, payload.encode(), hashlib.sha256).hexdigest()
        return base64.urlsafe_b64encode(f"{payload}|{sig}".encode()).decode()

    def verify_cookie(self, cookie: str, now: float | None = None) -> str | None:
        try:
            payload = base64.urlsafe_b64decode(cookie.encode()).decode()
            user, exp, sig = payload.rsplit("|", 2)
            want = hmac.new(self.cookie_key, f"{user}|{exp}".encode(),
                            hashlib.sha256).hexdigest()
            if not hmac.compare_digest(sig, want):
                return None
            if int(exp) < (self.clock() if now is None else now):
                return None
            return user
        except Exception:
            return None

    # -- checks -------------------------------------------------------------

    def auth_basic(self, req: HttpReq) -> str | None:
        """authpwd (:118)."""
        hdr = req.header("authorization")
        if not hdr.startswith("Basic "):
            return None
        try:
            user, _, pw = base64.b64decode(hdr[6:]).decode().partition(":")
        except Exception:
            return None
        if user == self.username and hmac.compare_digest(
            pwhash(pw, self.salt), self.passhash
        ):
            return user
        return None

    def auth_cookie(self, req: HttpReq) -> str | None:
        cookies = {}
        for part in req.header("cookie").split(";"):
            if "=" in part:
                k, v = part.strip().split("=", 1)
                cookies[k] = v
        tok = cookies.get(COOKIE_NAME)
        return self.verify_cookie(tok) if tok else None

    # -- endpoints ----------------------------------------------------------

    def check(self, req: HttpReq):
        """The ext-authz endpoint (ServeHTTP :62). 200 + identity header
        on allow; 302 to login for browsers; 401 for API clients."""
        user = self.auth_basic(req) or self.auth_cookie(req)
        if user:
            return HttpResp(status=200, body=b"{}",
                            headers={USER_HEADER: user})
        accepts = req.header("accept", "")
        if "text/html" in accepts:
            return HttpResp(status=302, body=b"",
                            headers={"Location": self.login_url})  # :161
        return HttpResp(status=401, body=b'{"error": "unauthorized"}')

    def login(self, req: HttpReq):
        """POST {username, password} -> Set-Cookie (:183)."""
        body = req.json() or {}
        user, pw = body.get("username", ""), body.get("password", "")
        if user == self.username and hmac.compare_digest(
            pwhash(pw, self.salt), self.passhash
        ):
            cookie = self.mint_cookie(user)
            return HttpResp(
                status=200, body=b'{"status": "ok"}',
                headers={"Set-Cookie":
                         f"{COOKIE_NAME}={cookie}; Path=/; HttpOnly"},
            )
        return HttpResp(status=401, body=b'{"error": "bad credentials"}')

    def logout(self, req: HttpReq):
        return HttpResp(status=200, body=b'{"status": "ok"}',
                        headers={"Set-Cookie":
                                 f"{COOKIE_NAME}=; Path=/; Max-Age=0"})

    def router(self) -> Router:
        r = Router("gatekeeper")
        r.route("GET", "/auth", self.check)
        r.route("POST", "/login", self.login)
        r.route("POST", "/logout", self.logout)
        httpd.add_health_routes(r)
        httpd.add_metrics_route(r)
        return r

    def serve(self, host: str = "0.0.0.0", port: int = 0) -> httpd.HttpService:
        return httpd.HttpService(self.router(), host, port)
