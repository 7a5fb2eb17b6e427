"""Reconcile controller: keep this node's GPU labels in sync.

The port's copy of the JAX package's ``labeller/controller.py``: labels
are recomputed on every reconcile, and the whole delta, removals
included, lands in one merge-patch request; a watch on the node (with
resourceVersion resume and clean re-lists on 410 Gone) triggers
reconciles between intervals.
"""

from __future__ import annotations

import http.client
import logging
import threading
from typing import Callable, Dict, Optional

from ..types import constants
from .k8s_client import ApiError, NodeClient

log = logging.getLogger(__name__)

_PREFIXES = (f"{constants.LABEL_PREFIX}.", f"{constants.LABEL_PREFIX_BETA}.")


def label_delta(
    current: Dict[str, str], desired: Dict[str, str]
) -> Dict[str, Optional[str]]:
    """Merge-patch delta from a node's current labels to the desired set:
    stale labels under our prefixes → None (delete), changed/new → value."""
    delta: Dict[str, Optional[str]] = {}
    for key in current:
        if key.startswith(_PREFIXES) and key not in desired:
            delta[key] = None
    for key, val in desired.items():
        if current.get(key) != val:
            delta[key] = val
    return delta


class NodeLabelController:
    """Periodic (and watch-triggered) reconciliation of one node's labels."""

    def __init__(
        self,
        client: NodeClient,
        node_name: str,
        compute_labels: Callable[[], Dict[str, str]],
        interval_s: float = 60.0,
    ):
        self.client = client
        self.node_name = node_name
        self.compute_labels = compute_labels
        self.interval = interval_s
        self._stop = threading.Event()
        # resourceVersion to resume the watch from (informer semantics);
        # None forces the next watch to start fresh after a re-list
        self._last_rv: Optional[str] = None

    def reconcile(
        self, desired: Optional[Dict[str, str]] = None
    ) -> Dict[str, Optional[str]]:
        """One pass; returns the applied delta (empty = already in sync).
        *desired* skips recomputation when the caller already has it."""
        node = self.client.get_node(self.node_name)
        meta = node.get("metadata") or {}
        self._last_rv = meta.get("resourceVersion")
        current = meta.get("labels") or {}
        if desired is None:
            desired = self.compute_labels()
        delta = label_delta(current, desired)
        if delta:
            updated = self.client.patch_node_labels(self.node_name, delta)
            # resume the watch from the PATCH response's version: it IS our
            # own update, so starting there also skips the self-induced
            # MODIFIED event a replay from the GET's version would deliver
            rv = (updated.get("metadata") or {}).get("resourceVersion")
            if rv:
                self._last_rv = rv
            log.info(
                "reconciled %s: %d set, %d removed",
                self.node_name,
                sum(1 for v in delta.values() if v is not None),
                sum(1 for v in delta.values() if v is None),
            )
        return delta

    @staticmethod
    def _event_needs_reconcile(event: dict, desired: Dict[str, str]) -> bool:
        """Cheap filter before paying a discovery pass: skip watch events
        whose label state already matches what we last computed.  Weeds out
        the watch's initial replay of the current object, the MODIFIED we
        cause with our own PATCH, and kubelet status heartbeats."""
        if event.get("type") not in ("ADDED", "MODIFIED"):
            return False
        obj = event.get("object") or {}
        current = (obj.get("metadata") or {}).get("labels") or {}
        return bool(label_delta(current, desired))

    def run(self) -> None:
        """Reconcile loop: immediate pass, then watch the node for changes
        with the interval as both watch timeout and error backoff (an
        informer filtered to our own node by field selector)."""
        while not self._stop.is_set():
            try:
                desired = self.compute_labels()
                self.reconcile(desired)
            except (ApiError, OSError, http.client.HTTPException) as e:
                log.error("reconcile failed: %s", e)
                self._stop.wait(min(self.interval, 10.0))
                continue
            try:
                for event in self.client.watch_node(
                    self.node_name, timeout_s=int(self.interval),
                    resource_version=self._last_rv,
                ):
                    if self._stop.is_set():
                        return
                    if self._handle_gone(event):
                        break  # clean re-list via the outer loop, no backoff
                    desired = self._process_event(event, desired)
            except ApiError as e:
                if e.status == 410:
                    # history compacted past our resourceVersion: re-list
                    # immediately (informer semantics), not generic backoff
                    log.info("watch expired (410 Gone); re-listing")
                    self._last_rv = None
                    continue
                log.warning("watch failed (%s); falling back to poll", e)
                self._stop.wait(self.interval)
            except (OSError, http.client.HTTPException) as e:
                # HTTPException: a dropped chunked stream mid-read raises
                # IncompleteRead and friends, which are NOT OSErrors — an
                # apiserver restart must not kill the reconcile loop
                log.warning("watch failed (%s); falling back to poll", e)
                self._stop.wait(self.interval)

    def _process_event(
        self, event: dict, desired: Dict[str, str]
    ) -> Dict[str, str]:
        """One non-ERROR watch event: advance the resume point to the
        event's resourceVersion (so a mid-stream reconnect doesn't replay
        it), then reconcile if the labels drifted.  Returns the possibly
        recomputed desired set."""
        rv = (
            (event.get("object") or {}).get("metadata") or {}
        ).get("resourceVersion")
        if rv:
            self._last_rv = rv
        if self._event_needs_reconcile(event, desired):
            # recompute: the divergence may reflect new hardware
            # state, not just someone deleting our labels
            desired = self.compute_labels()
            self.reconcile(desired)
        return desired

    def _handle_gone(self, event: dict) -> bool:
        """True for a 410 Gone ERROR event (etcd compacted past our
        resourceVersion) — the watch must be restarted from a fresh list."""
        if event.get("type") != "ERROR":
            return False
        code = (event.get("object") or {}).get("code")
        if code == 410:
            log.info("watch event 410 Gone; re-listing")
            self._last_rv = None
            return True
        log.warning("watch ERROR event: %s", event)
        return False

    def stop(self) -> None:
        self._stop.set()
