"""Self-signed CA bootstrap and TLS serving for the platform edge.

Port of `kubeflow_tpu/utils/tlscerts.py`. Kubernetes refuses plain-HTTP
admission webhooks: the apiserver dials the webhook Service over HTTPS
and verifies the chain against the registration's
``clientConfig.caBundle``. The reference serves its PodDefault webhook
with ``--tlsCertFile/--tlsKeyFile`` (admission-webhook/main.go:541-542)
and leaves the CA to an out-of-band cert-gen job; here the bootstrap is
in-tree: an idempotent on-disk CA that issues a SAN-correct serving cert
for ``<service>.<namespace>.svc`` and hands back the b64 caBundle that
the webhook patches into its MutatingWebhookConfiguration.

Everything is PEM on disk, so the same files mount as a standard
``kubernetes.io/tls`` Secret. The module stands on `cryptography`, which
the GPU worker image need not have: the webhook imports it only when it
serves HTTPS (`control/poddefault/webhook.py` `serve(certs_dir=)`), and
nothing on the training path imports it.
"""

from __future__ import annotations

import base64
import datetime
import ipaddress
import ssl
from dataclasses import dataclass
from pathlib import Path

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID


def _name(cn: str) -> x509.Name:
    return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])


def _key() -> ec.EllipticCurvePrivateKey:
    # P-256: small certs, fast handshakes; kube's own cert-gen default
    return ec.generate_private_key(ec.SECP256R1())


def _pem_key(key) -> bytes:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )


def generate_ca(common_name: str = "kubeflow-tpu-torch-ca",
                days: int = 3650) -> tuple[bytes, bytes]:
    """Return (ca_cert_pem, ca_key_pem) for a fresh self-signed CA."""
    key = _key()
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(_name(common_name))
        .issuer_name(_name(common_name))
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
        .add_extension(
            x509.KeyUsage(digital_signature=True, key_cert_sign=True,
                          crl_sign=True, content_commitment=False,
                          key_encipherment=False, data_encipherment=False,
                          key_agreement=False, encipher_only=False,
                          decipher_only=False),
            critical=True,
        )
        .sign(key, hashes.SHA256())
    )
    return cert.public_bytes(serialization.Encoding.PEM), _pem_key(key)


def issue_server_cert(ca_cert_pem: bytes, ca_key_pem: bytes,
                      dns_names: list[str], days: int = 825,
                      ip_addresses: list[str] | None = None) -> tuple[bytes, bytes]:
    """Issue a serving cert signed by the CA. The apiserver verifies the
    SAN against the Service DNS name, so ``dns_names`` must include
    ``<svc>.<ns>.svc`` (and the test harness adds localhost/127.0.0.1)."""
    ca_cert = x509.load_pem_x509_certificate(ca_cert_pem)
    ca_key = serialization.load_pem_private_key(ca_key_pem, password=None)
    key = _key()
    now = datetime.datetime.now(datetime.timezone.utc)
    sans: list[x509.GeneralName] = [x509.DNSName(d) for d in dns_names]
    for ip in ip_addresses or []:
        sans.append(x509.IPAddress(ipaddress.ip_address(ip)))
    cert = (
        x509.CertificateBuilder()
        .subject_name(_name(dns_names[0]))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .add_extension(x509.BasicConstraints(ca=False, path_length=None),
                       critical=True)
        .add_extension(
            x509.ExtendedKeyUsage([x509.oid.ExtendedKeyUsageOID.SERVER_AUTH]),
            critical=False,
        )
        .sign(ca_key, hashes.SHA256())
    )
    return cert.public_bytes(serialization.Encoding.PEM), _pem_key(key)


@dataclass
class CertPaths:
    ca_cert: Path   # ca.crt — what clients (the apiserver) trust
    cert: Path      # tls.crt — the serving cert
    key: Path       # tls.key

    @property
    def ca_bundle_b64(self) -> str:
        """clientConfig.caBundle value for the webhook registration."""
        return base64.b64encode(self.ca_cert.read_bytes()).decode()


def ensure_certs(certs_dir: str | Path, service: str,
                 namespace: str = "kubeflow") -> CertPaths:
    """Idempotent bootstrap: create (or reuse) a CA + serving cert pair in
    ``certs_dir``. File names follow the kubernetes.io/tls Secret layout so
    a real deployment can mount the directory as a Secret volume."""
    d = Path(certs_dir)
    paths = CertPaths(ca_cert=d / "ca.crt", cert=d / "tls.crt", key=d / "tls.key")
    if paths.ca_cert.exists() and paths.cert.exists() and paths.key.exists():
        # pre-provisioned (e.g. a read-only mounted Secret without ca.key):
        # never regenerate — the registered caBundle pins this CA
        return paths
    d.mkdir(parents=True, exist_ok=True)
    ca_key_path = d / "ca.key"
    if not (paths.ca_cert.exists() and ca_key_path.exists()):
        ca_cert, ca_key = generate_ca(f"{service}-ca")
        paths.ca_cert.write_bytes(ca_cert)
        ca_key_path.write_bytes(ca_key)
        ca_key_path.chmod(0o600)
        # CA rotated -> any existing serving cert is now untrusted
        paths.cert.unlink(missing_ok=True)
        paths.key.unlink(missing_ok=True)
    if not (paths.cert.exists() and paths.key.exists()):
        cert, key = issue_server_cert(
            paths.ca_cert.read_bytes(), ca_key_path.read_bytes(),
            dns_names=[f"{service}.{namespace}.svc",
                       f"{service}.{namespace}.svc.cluster.local",
                       service, "localhost"],
            ip_addresses=["127.0.0.1"],
        )
        paths.cert.write_bytes(cert)
        paths.key.write_bytes(key)
        paths.key.chmod(0o600)
    return paths


def server_context(certfile: str | Path, keyfile: str | Path) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(str(certfile), str(keyfile))
    return ctx


def client_context(ca_file: str | Path) -> ssl.SSLContext:
    """Verifying client context — how the apiserver dials the webhook."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(str(ca_file))
    ctx.check_hostname = True
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx
