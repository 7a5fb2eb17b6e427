"""Minimal in-cluster Kubernetes API client for Node objects.

The port's copy of the JAX package's ``labeller/k8s_client.py``: three
verbs against one resource over stdlib HTTPS -- GET node, PATCH labels
(JSON merge patch: a null value deletes a label, so stale-label cleanup
is one request) and a long-poll WATCH -- with the service-account
credentials, under the shared retry policy.  The API base URL and every
path are injectable, so tests drive it against a local fake.
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import urllib.error
import urllib.request
from typing import Dict, Iterator, Optional

from .. import resilience
from ..resilience import faults

log = logging.getLogger(__name__)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class ApiError(Exception):
    def __init__(self, status: int, body: str):
        super().__init__(f"API server returned {status}: {body[:200]}")
        self.status = status
        self.body = body


class TransientApiError(ApiError):
    """5xx/429 — the API server's problem, safe to retry.  Subclasses
    ApiError so existing ``except ApiError`` callers see no change."""


# the failures worth retrying a node GET/PATCH over: connection-level
# faults, server-side 5xx/429, and injected faults in chaos runs
_RETRYABLE = (TransientApiError, urllib.error.URLError, TimeoutError,
              ConnectionError, faults.InjectedFault)


class NodeClient:
    """Talks to ``/api/v1/nodes`` with service-account credentials."""

    def __init__(
        self,
        base_url: Optional[str] = None,
        token_path: str = os.path.join(SA_DIR, "token"),
        ca_path: str = os.path.join(SA_DIR, "ca.crt"),
        timeout_s: float = 10.0,
        retry: Optional["resilience.RetryPolicy"] = None,
        resilience_metrics: Optional[
            "resilience.ResilienceMetrics"] = None,
    ):
        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            base_url = f"https://{host}:{port}"
        self.base_url = base_url.rstrip("/")
        self._token_path = token_path
        self._timeout = timeout_s
        # shared policy: transient API-server faults (connection reset,
        # 5xx, 429) retry with jittered backoff instead of failing the
        # whole reconcile round
        self._retry = retry if retry is not None else \
            resilience.RetryPolicy(max_attempts=3,
                                   initial_backoff_s=0.25,
                                   max_backoff_s=2.0)
        self._res_metrics = resilience_metrics
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if self.base_url.startswith("https") and os.path.exists(ca_path):
            self._ssl_ctx = ssl.create_default_context(cafile=ca_path)

    # -- plumbing -----------------------------------------------------------

    def _token(self) -> str:
        # re-read per request: projected SA tokens rotate
        try:
            with open(self._token_path, "r", encoding="utf-8") as f:
                return f.read().strip()
        except OSError:
            return ""

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        content_type: str = "application/json",
        timeout: Optional[float] = None,
        retryable: bool = True,
    ):
        """One API-server round trip; *retryable* GET/PATCH calls run
        under the shared RetryPolicy (long-poll WATCH passes False —
        its reconnect loop belongs to the controller)."""
        def _once():
            if faults.ACTIVE is not None:
                faults.ACTIVE.fire("k8s.request")
            req = urllib.request.Request(
                self.base_url + path,
                method=method,
                data=json.dumps(body).encode()
                if body is not None else None,
            )
            token = self._token()
            if token:
                req.add_header("Authorization", f"Bearer {token}")
            req.add_header("Accept", "application/json")
            if body is not None:
                req.add_header("Content-Type", content_type)
            try:
                return urllib.request.urlopen(
                    req, timeout=timeout or self._timeout,
                    context=self._ssl_ctx
                )
            except urllib.error.HTTPError as e:
                text = e.read().decode(errors="replace")
                if e.code >= 500 or e.code == 429:
                    raise TransientApiError(e.code, text) from e
                raise ApiError(e.code, text) from e

        if not retryable:
            return _once()
        return self._retry.call(
            _once, op="k8s.request", retry_on=_RETRYABLE,
            metrics=self._res_metrics, logger=log)

    # -- node verbs ---------------------------------------------------------

    def get_node(self, name: str) -> dict:
        with self._request("GET", f"/api/v1/nodes/{name}") as resp:
            return json.load(resp)

    def patch_node_labels(
        self, name: str, labels: Dict[str, Optional[str]]
    ) -> dict:
        """Apply a label delta; a None value removes that label (JSON merge
        patch semantics, RFC 7386)."""
        patch = {"metadata": {"labels": labels}}
        with self._request(
            "PATCH",
            f"/api/v1/nodes/{name}",
            body=patch,
            content_type="application/merge-patch+json",
        ) as resp:
            return json.load(resp)

    def watch_node(
        self, name: str, timeout_s: int = 60,
        resource_version: Optional[str] = None,
    ) -> Iterator[dict]:
        """Yield watch events for one node until the server closes the
        long-poll (bounded by ``timeoutSeconds``).

        With *resource_version* the server only sends events newer than
        that version (informer semantics — no replay of the current
        object on every reconnect).  A too-old version surfaces as HTTP
        410 (ApiError) or an ERROR event with ``object.code == 410``;
        callers must then re-list and restart the watch fresh."""
        path = (
            f"/api/v1/nodes?watch=true"
            f"&fieldSelector=metadata.name%3D{name}"
            f"&timeoutSeconds={timeout_s}"
        )
        if resource_version:
            path += f"&resourceVersion={resource_version}"
        with self._request("GET", path, timeout=timeout_s + 5,
                           retryable=False) as resp:
            for line in resp:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    log.warning("unparseable watch line: %r", line[:120])
