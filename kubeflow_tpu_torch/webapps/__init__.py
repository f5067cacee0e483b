"""User-facing web app backends (port of `kubeflow_tpu/webapps/`,
SURVEY.md §2.3).

- ``jwa``          — the Jupyter web app REST backend (reference:
  components/jupyter-web-app/backend): notebook spawner APIs, its GPU
  form writing ``nvidia.com/gpu``; ``jwa_ui`` its spawner page,
  ``jwa_flavors`` its $UI flavors, ``jwa_main`` its entry point.
- ``crud_backend`` — the shared CRUD app backend (authn, authz against
  Profiles and their role bindings, resource routes).

The central dashboard and the tensorboards app are not ported yet.
"""
