"""Artifact store (port of :mod:`mmtpu.io.artifacts`)."""
