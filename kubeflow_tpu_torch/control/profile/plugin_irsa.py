"""AWS IRSA profile plugin: IAM Roles for Service Accounts.

Port of `kubeflow_tpu/control/profile/plugin_irsa.py` (no accelerator
in it: the same code over the port's modules).

Mirrors the capability of the reference's AwsIAMForServiceAccount plugin
(profile-controller/controllers/plugin_iam.go:27-284):

- ``apply`` annotates the namespace's default-editor ServiceAccount with
  ``eks.amazonaws.com/role-arn`` (plugin_iam.go:110-117) and adds the
  ``system:serviceaccount:<ns>:<sa>`` web-identity subject to the IAM
  role's trust (assume-role) policy (:127-177).
- ``revoke`` removes both again (:42-50, :179-238).

The trust-policy JSON surgery is pure-Python here (the reference uses
gjson): it operates on Statement[0] only, reads the OIDC provider from
``Statement.0.Principal.Federated``, rebuilds the condition with the
default audience plus the updated subject list, and omits the ``:sub``
key entirely when the list empties (plugin_iam.go:213-227 — an empty
JSON array would break AWS policy validation).

AWS API access goes through an injectable backend (the reference holds a
live aws-sdk client, untestable offline); the policy functions are the
meat, held against the JAX package's by
tests/test_torch_control_profile.py on the cases of plugin_iam_test.go.
"""

from __future__ import annotations

import json
import logging
import urllib.parse
from typing import Protocol

from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.profile import types as T

log = logging.getLogger("kubeflow_tpu_torch.profile.irsa")

KIND = "AwsIamForServiceAccount"
ANNOTATION = "eks.amazonaws.com/role-arn"            # plugin_iam.go:22
TRUST_IDENTITY_SUBJECT = "system:serviceaccount:{ns}:{sa}"  # :23
DEFAULT_AUDIENCE = "sts.amazonaws.com"               # :24


class ConditionExistsError(Exception):
    """The subject is already in the trust policy (plugin_iam.go:278)."""


class IamBackend(Protocol):
    """The slice of the AWS IAM API the plugin needs.

    ``get_role`` returns the role's assume-role policy document as the
    AWS API does: URL-quoted JSON (plugin_iam.go:85 notes the encoding).
    """

    def get_assume_role_policy(self, role_name: str) -> str: ...

    def update_assume_role_policy(self, role_name: str, policy_json: str) -> None: ...


def issuer_url_from_provider_arn(arn: str) -> str:
    """arn:aws:iam::<acct>:oidc-provider/<issuerUrl> -> issuerUrl (:241-243)."""
    return arn[arn.index("/") + 1:] if "/" in arn else arn


def role_name_from_arn(arn: str) -> str:
    """arn:aws:iam::<acct>:role/<name> -> name (:245-247)."""
    return arn[arn.rindex("/") + 1:] if "/" in arn else arn


def make_assume_role_with_web_identity_policy_document(
        provider_arn: str, condition: dict) -> dict:
    """Trust-policy statement for a web-identity provider (:250-259)."""
    return {
        "Effect": "Allow",
        "Action": "sts:AssumeRoleWithWebIdentity",
        "Principal": {"Federated": provider_arn},
        "Condition": condition,
    }


def make_policy_document(*statements: dict) -> dict:
    """Wrap statements in a policy document (:262-267)."""
    return {"Version": "2012-10-17", "Statement": list(statements)}


def _parse(policy_document: str):
    """Load the doc and locate Statement[0]'s web-identity condition.

    Unlike the reference — which rebuilds a single-statement document
    from scratch, deleting sibling statements, non-StringEquals
    operators, extra condition keys, and any custom audience
    (plugin_iam.go:163-175) — we edit the document in place: only the
    ``<issuer>:sub`` list (and a defaulted ``<issuer>:aud``) of the
    first statement changes; everything else round-trips untouched.
    """
    doc = json.loads(policy_document)
    statements = doc.get("Statement") or []
    if not statements:
        raise ValueError("trust policy has no statements")
    # Like the reference, the subject list lives on the first statement
    # (:147 comment) — but the rest of the document is preserved.
    stmt = statements[0]
    provider_arn = ((stmt.get("Principal") or {}).get("Federated")) or ""
    issuer = issuer_url_from_provider_arn(provider_arn)
    equals = stmt.setdefault("Condition", {}).setdefault("StringEquals", {})
    subjects = equals.get(f"{issuer}:sub") or []
    if isinstance(subjects, str):
        subjects = [subjects]
    return doc, issuer, equals, list(subjects)


def add_service_account_in_assume_role_policy(
        policy_document: str, ns: str, sa: str) -> str:
    """Add <ns>/<sa>'s web-identity subject to the trust policy (:127-177).

    Raises ConditionExistsError when the subject is already present, so
    the caller can skip the (non-idempotent-priced) AWS update call.
    """
    doc, issuer, equals, subjects = _parse(policy_document)
    trust_identity = TRUST_IDENTITY_SUBJECT.format(ns=ns, sa=sa)
    if trust_identity in subjects:
        raise ConditionExistsError(trust_identity)
    subjects.append(trust_identity)
    equals.setdefault(f"{issuer}:aud", [DEFAULT_AUDIENCE])
    equals[f"{issuer}:sub"] = subjects
    return json.dumps(doc)


def remove_service_account_in_assume_role_policy(
        policy_document: str, ns: str, sa: str) -> str:
    """Remove <ns>/<sa>'s subject; drop the :sub key when empty (:179-238
    — an empty JSON array breaks AWS policy validation).

    Raises ConditionExistsError when the subject is absent (nothing to
    remove), so revoke can skip the AWS write — the short-circuit the
    reference's remove path lacks.
    """
    doc, issuer, equals, subjects = _parse(policy_document)
    trust_identity = TRUST_IDENTITY_SUBJECT.format(ns=ns, sa=sa)
    if trust_identity not in subjects:
        raise ConditionExistsError(trust_identity)
    remaining = [s for s in subjects if s != trust_identity]
    if remaining:
        equals[f"{issuer}:sub"] = remaining
    else:
        equals.pop(f"{issuer}:sub", None)
    equals.setdefault(f"{issuer}:aud", [DEFAULT_AUDIENCE])
    return json.dumps(doc)


class IrsaPlugin:
    """Profile plugin: pairs the namespace's editor SA with an IAM role."""

    KIND = KIND

    def __init__(self, iam_backend: IamBackend | None = None):
        self.iam = iam_backend

    def _role_arn(self, profile: dict) -> str | None:
        from kubeflow_tpu_torch.control.profile.controller import plugin_spec_field

        return plugin_spec_field(profile, self.KIND, "awsIamRole")

    def _patch_annotation(self, client, ns: str, arn: str | None) -> None:
        sa = client.get_or_none("v1", "ServiceAccount", T.SA_EDITOR, ns)
        if sa is None:
            return
        if arn is not None:
            ob.set_annotation(sa, ANNOTATION, arn)
        else:
            annos = ob.annotations_of(sa)
            annos.pop(ANNOTATION, None)
        client.update(sa)

    def _update_trust_policy(self, arn: str, ns: str, update_fn) -> None:
        if not self.iam:
            log.warning(
                "IRSA plugin has no IAM backend configured: %s annotated on "
                "%s/%s but the role trust policy was NOT updated — "
                "AssumeRoleWithWebIdentity will fail until it is", arn, ns,
                T.SA_EDITOR)
            return
        role = role_name_from_arn(arn)
        encoded = self.iam.get_assume_role_policy(role)
        decoded = urllib.parse.unquote(encoded)  # AWS URL-quotes the doc (:85)
        try:
            updated = update_fn(decoded, ns, T.SA_EDITOR)
        except ConditionExistsError:
            return  # already present: skip the update (:93-96)
        self.iam.update_assume_role_policy(role, updated)

    def apply(self, client, profile: dict) -> None:
        arn = self._role_arn(profile)
        if not arn:
            return
        ns = ob.meta(profile)["name"]
        self._patch_annotation(client, ns, arn)
        self._update_trust_policy(arn, ns, add_service_account_in_assume_role_policy)

    def revoke(self, client, profile: dict) -> None:
        arn = self._role_arn(profile)
        if not arn:
            return
        ns = ob.meta(profile)["name"]
        self._patch_annotation(client, ns, None)
        self._update_trust_policy(arn, ns, remove_service_account_in_assume_role_policy)
