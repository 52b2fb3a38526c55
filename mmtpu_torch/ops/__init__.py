"""Likelihood ops on tensors (ports of :mod:`mmtpu.ops`)."""
