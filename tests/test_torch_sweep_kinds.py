"""The port's sweep chunk against ``mmtpu.sweep.run_sweep`` for a non-e2e
dense-Adam chunk (``lazy_adam=False``) and a POM chunk (e2e, lazy Adam, 17
traits), each of one epoch count (one mmtpu program); the e2e lazy-Adam and
SGD chunks, the draws and the tolerances: tests/test_torch_sweep.py.
"""

import pytest

from tests.test_torch_sweep import check_case, grid, one_torch_thread, tiny_prep  # noqa: F401

CASES = {
    "nonE2e_dense_adam": (dict(configs=grid("adam", e2e=False, k=3, n_epochs=(2, 2, 2)),
                               lazy_adam=False), "mosi"),
    "pom": (dict(configs=grid("adam", k=3, n_epochs=(2, 2, 2)), lazy_adam=True), "pom"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_matches_mmtpu_sweep(case):
    spec, dataset = CASES[case]
    check_case(spec, tiny_prep(dataset))
