"""The port's acceptance drivers and their stdlib helpers, each runnable
as ``python -m tpu_k8s_device_plugin_torch.tools.<name>``:

- ``chaos_soak``: seeded fault episodes over a two-host slice of the
  port's node agents and over its serving engines, routers and fleets;
- ``trace_smoke``, ``alert_smoke``, ``incident_smoke``: one
  observability contract each, against a subprocess running the port's
  server;
- ``obs_query``: traces, flight-recorder dumps, replay reports, live
  dashboards and incident bundles, rendered from the port's ``obs``;
- ``promlint``: the exposition linter;
- ``fake_kubelet``: an in-process kubelet speaking the device-plugin
  API over the port's ``proto``.
"""
