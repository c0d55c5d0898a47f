"""Plain NumPy stencil references, independent of the library's lowering.

An apply over `interior` writes fn(shifted reads) inside the box and copies
input0 through outside it (the IR's copy-through contract). Reads that leave
the array are zero, or wrap when periodic (the apply contract leaves them
unspecified unless periodic; they only reach cells that a mask discards).
Everything is evaluated in float64.
"""

import numpy as np

LAP5 = [((0, 0), 4.0), ((-1, 0), -1.0), ((1, 0), -1.0), ((0, -1), -1.0),
        ((0, 1), -1.0)]
LAP7 = [((0, 0, 0), 6.0)] + [
    (tuple(s if e == d else 0 for e in range(3)), -1.0)
    for d in range(3)
    for s in (-1, 1)
]
ADV4 = [((0, 0), 1.0)] + [
    (off, -0.1 * w * c / 12.0)
    for w, axis in ((0.7, 0), (0.3, 1))
    for s, c in ((2, -1.0), (1, 8.0), (-1, -8.0), (-2, 1.0))
    for off in [tuple(s if e == axis else 0 for e in range(2))]
]


def interior(shape, h):
    """The (lo, hi) box that keeps a reach-h stencil inside the array."""
    hs = (h,) * len(shape) if isinstance(h, int) else tuple(h)
    return tuple(hs), tuple(n - k for n, k in zip(shape, hs))


def shift(x, off, periodic=False):
    """y[i] = x[i + off]."""
    if periodic:
        return np.roll(x, tuple(-o for o in off), axis=tuple(range(x.ndim)))
    y = np.zeros_like(x)
    src, dst = [], []
    for o, n in zip(off, x.shape):
        o = max(-n, min(o, n))
        src.append(slice(o, n) if o >= 0 else slice(0, n + o))
        dst.append(slice(0, n - o) if o >= 0 else slice(-o, n))
    y[tuple(dst)] = x[tuple(src)]
    return y


def apply(x, fn, box=None, periodic=False, seed=None):
    """fn(read) inside box, seed (default x) outside; read(*off) -> shifted x."""
    x = np.asarray(x, np.float64)
    y = np.asarray(fn(lambda *off: shift(x, off, periodic)), np.float64)
    y = np.broadcast_to(y, x.shape)
    if box is None:
        return y.copy()
    out = (x if seed is None else np.asarray(seed, np.float64)).copy()
    sl = tuple(slice(lo, hi) for lo, hi in zip(*box))
    out[sl] = y[sl]
    return out


def linear(x, offsets_coefs, box=None, periodic=False):
    """sum_c c * x[i + off] inside box, copy-through outside."""
    return apply(
        x,
        lambda read: sum(c * read(*o) for o, c in offsets_coefs),
        box,
        periodic,
    )


def sweeps(x, offsets_coefs, k, box=None, periodic=False):
    """k applications of `linear`."""
    y = np.asarray(x, np.float64)
    for _ in range(k):
        y = linear(y, offsets_coefs, box, periodic)
    return y
