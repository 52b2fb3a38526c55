"""The plain reference that decides a run's ``correct``: plain PyTorch and
NumPy, importing nothing of the program."""
