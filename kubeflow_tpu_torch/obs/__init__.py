"""Observability pieces the port needs: spans and the exposition parser."""
