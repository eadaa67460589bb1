"""Small sizes of every cell for the CPU tests, and the ``cuda`` marker
for tests that need the card (decided inside a fixture, never while a
module is imported)."""

import pytest

SMALL = {
    "kron20-bfs": {"config": {"scale": 9, "search_roots": 8},
                   "workload": {"sample": 4, "profile_items": 4}},
    "kron20-pagerank": {"config": {"scale": 9, "search_roots": 8},
                        "workload": {"sample": 2, "profile_items": 2}},
    "arxiv-gcn-train": {
        "config": {"num_nodes": 300, "num_edges": 1200, "feature_dim": 16,
                   "num_classes": 8,
                   "split": {"train": 150, "valid": 50, "test": 100},
                   "dims": [16, 32, 32, 8]},
        "workload": {"profile_items": 2}},
}
SEED = 2**31 + 12345  # more than 32 signed bits hold


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
