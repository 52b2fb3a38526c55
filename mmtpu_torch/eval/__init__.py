"""Result metrics and reports on numpy predictions (ports of :mod:`mmtpu.eval`)."""
