"""Observability pieces the port needs: spans, the exposition parser and
the control plane's event recorder."""
