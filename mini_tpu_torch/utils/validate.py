"""Result validators (gunrock's `tests/test_utils.hxx:193-213`: exact int
compare + 0.01-abs-tol float compare).  Take NumPy arrays or CPU tensors."""

from __future__ import annotations

import numpy as np


def validate_exact(got, expected) -> bool:
    got = np.asarray(got)
    expected = np.asarray(expected)
    return got.shape == expected.shape and bool(np.all(got == expected))


def validate_close(got, expected, atol: float = 0.01) -> bool:
    got = np.asarray(got, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    if got.shape != expected.shape:
        return False
    both_inf = np.isinf(got) & np.isinf(expected) & (
        np.sign(got) == np.sign(expected)
    )
    return bool(np.all(both_inf | (np.abs(got - expected) <= atol)))


def display_device_data(arr, limit: int = 40, name: str = "") -> None:
    """Print an array (gunrock's `tests/test_utils.hxx:157-166`)."""
    a = np.asarray(arr)
    head = a[:limit]
    print(f"{name}[{a.shape}]: {head}{' ...' if a.size > limit else ''}")
