"""Model parameter dicts and functional forward passes (ports of :mod:`mmtpu.models`)."""
