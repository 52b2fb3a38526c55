"""Training loops: the latent fit, the optimizer and the sentiment fit (ports of :mod:`mmtpu.train`)."""
