"""Compensated (double-float) accumulation for float32 runs.

Port of ipc_tpu/ops/compensated.py, kept literal: the error-free
transformations (Knuth two-sum, Dekker quick-two-sum) rely on every add
being rounded exactly as written. PyTorch runs each op eagerly and never
reassociates, so these functions are exact as long as nobody runs them
under `torch.compile` or another pass that reorders sums — never do that.

The f32 line search needs them: the barrier term is ~1e-7 of
inertia+elasticity in a contact step, so a plain-f32 `E_try <= E0` cannot
see it; (hi, lo) pairs give ~48-bit resolution in f32 arithmetic.
"""

import torch

__all__ = [
    "two_sum",
    "quick_two_sum",
    "df_sum",
    "df_add",
    "df_scale",
    "df_leq",
    "df_to_float",
]


def two_sum(a, b):
    """Knuth's error-free addition: a + b = s + err exactly (IEEE RN)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Dekker's fast two-sum; requires |a| >= |b| (holds after two_sum)."""
    s = a + b
    err = b - (s - a)
    return s, err


def df_sum(x):
    """Pairwise double-float sum of a tensor -> (hi, lo) 0-d tensors.

    Log-depth tree of two-sums with error propagation over the flattened
    input, padded with exact zeros to a power of two."""
    x = x.reshape(-1)
    n = x.shape[0]
    p = 1 if n == 0 else 1 << max(0, (n - 1).bit_length())
    hi = torch.zeros((p,), dtype=x.dtype, device=x.device)
    hi[:n] = x
    lo = torch.zeros((p,), dtype=x.dtype, device=x.device)
    while p > 1:
        p //= 2
        s, e = two_sum(hi[:p], hi[p:])
        e = e + (lo[:p] + lo[p:])
        hi, lo = quick_two_sum(s, e)
    return hi[0], lo[0]


def df_add(a, b):
    """(hi, lo) + (hi, lo) -> normalized (hi, lo)."""
    a_hi, a_lo = a
    b_hi, b_lo = b
    s, e = two_sum(a_hi, b_hi)
    e = e + (a_lo + b_lo)
    return quick_two_sum(s, e)


def df_scale(a, k):
    """Scale (hi, lo) by a plain scalar k; each product rounds once (no
    two-prod), renormalized for df_leq."""
    return quick_two_sum(a[0] * k, a[1] * k)


def df_leq(a, b):
    """a <= b on normalized (hi, lo) pairs."""
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] <= b[1]))


def df_to_float(a, dtype=None):
    """Collapse (hi, lo) to a single float; only at the output boundary."""
    v = a[0] + a[1]
    return v if dtype is None else v.to(dtype)
