"""How XLA:CPU sums the two taps of each linear-resize output, per pass of
every pyramid level at the image sizes the repo ships.

The reference's ``jax.image.resize(linear, antialias=False)`` is one dot per
axis over the whole weight matrix. XLA:CPU hands each dot to its GEMM
library, which sums each output's two nonzero taps in one of two forms:

* "A": one fused multiply-add chain, ``fma(w1, x1, w0 * x0)``;
* "C": two rounded products summed, ``w0 * x0 + w1 * x1`` (the taps fall in
  different accumulators).

The form is the same for every output of a dot, except the outputs whose two
taps straddle an edge of the library's blocks along the contraction, which
take the other form. Which form a dot takes and where its block edges fall
depend on the library's blocking heuristics for the dot's three sizes and
the size of XLA:CPU's thread pool (8 threads here), not on (m, n) alone:
the same contraction length 370 is split at 192 in one dot and not in
another. ``FORMS`` is therefore a measured table, printed by
tools/resize_forms_torch.py: for each pass ``(axis, m, n, other)`` (axis 0:
rows, contraction m -> n over an image ``other`` wide; axis 1: columns,
m -> n with ``other`` rows), its base form and the outputs that take the
other one. A pass missing from it takes ``DEFAULT``, the forms most dots
take; such a size is not held exact.

The table belongs to the jax/jaxlib the tests pin, its GEMM library and an
8-thread pool: after an upgrade, rerun the tool and
tests/test_torch_frontend.py.
"""

from __future__ import annotations

import numpy as np

# (H, W) of every preset (presets.py) and of the tests
SHIPPED_SIZES = ((192, 256), (240, 320), (480, 640), (376, 1241), (370, 1226), (480, 752))

DEFAULT = {0: ("A", ()), 1: ("C", ())}

FORMS = {
    (0, 64, 54, 86): ('A', ()),
    (0, 77, 64, 103): ('A', ()),
    (0, 80, 67, 107): ('A', ()),
    (0, 93, 77, 123): ('A', ()),
    (0, 96, 80, 129): ('A', ()),
    (0, 111, 93, 148): ('A', ()),
    (0, 116, 96, 154): ('A', ()),
    (0, 124, 103, 411): ('A', ()),
    (0, 126, 105, 416): ('A', ()),
    (0, 133, 111, 178): ('A', (80,)),
    (0, 139, 116, 185): ('A', (80,)),
    (0, 149, 124, 493): ('A', ()),
    (0, 151, 126, 499): ('A', ()),
    (0, 160, 133, 213): ('A', ()),
    (0, 161, 134, 214): ('A', ()),
    (0, 161, 134, 252): ('A', ()),
    (0, 167, 139, 222): ('A', ()),
    (0, 178, 149, 591): ('A', ()),
    (0, 181, 151, 598): ('A', ()),
    (0, 192, 160, 256): ('A', ()),
    (0, 193, 161, 257): ('A', ()),
    (0, 193, 161, 302): ('A', ()),
    (0, 200, 167, 267): ('A', ()),
    (0, 214, 178, 709): ('A', ()),
    (0, 218, 181, 718): ('A', ()),
    (0, 231, 193, 309): ('A', ()),
    (0, 231, 193, 363): ('A', ()),
    (0, 240, 200, 320): ('A', ()),
    (0, 257, 214, 851): ('A', ()),
    (0, 261, 218, 862): ('A', ()),
    (0, 278, 231, 370): ('A', ()),
    (0, 278, 231, 435): ('A', ()),
    (0, 308, 257, 1022): ('A', ()),
    (0, 313, 261, 1034): ('A', ()),
    (0, 333, 278, 444): ('A', (140,)),
    (0, 333, 278, 522): ('A', (140,)),
    (0, 370, 308, 1226): ('A', (159,)),
    (0, 376, 313, 1241): ('A', (159,)),
    (0, 400, 333, 533): ('A', ()),
    (0, 400, 333, 627): ('A', ()),
    (0, 480, 400, 640): ('A', ()),
    (0, 480, 400, 752): ('A', ()),
    (1, 86, 71, 54): ('C', ()),
    (1, 103, 86, 64): ('C', ()),
    (1, 107, 89, 67): ('C', ()),
    (1, 123, 103, 77): ('C', ()),
    (1, 129, 107, 80): ('C', ()),
    (1, 148, 123, 93): ('A', ()),
    (1, 154, 129, 96): ('C', ()),
    (1, 178, 148, 111): ('C', ()),
    (1, 185, 154, 116): ('C', ()),
    (1, 213, 178, 133): ('A', ()),
    (1, 214, 179, 134): ('A', ()),
    (1, 222, 185, 139): ('A', ()),
    (1, 252, 210, 134): ('C', ()),
    (1, 256, 213, 160): ('C', ()),
    (1, 257, 214, 161): ('C', ()),
    (1, 267, 222, 167): ('C', ()),
    (1, 302, 252, 161): ('A', ()),
    (1, 309, 257, 193): ('C', ()),
    (1, 320, 267, 200): ('C', ()),
    (1, 363, 302, 193): ('C', ()),
    (1, 370, 309, 231): ('A', ()),
    (1, 411, 342, 103): ('C', ()),
    (1, 416, 346, 105): ('C', ()),
    (1, 435, 363, 231): ('C', ()),
    (1, 444, 370, 278): ('A', ()),
    (1, 493, 411, 124): ('C', ()),
    (1, 499, 416, 126): ('C', ()),
    (1, 522, 435, 278): ('A', (426,)),
    (1, 533, 444, 333): ('A', (426,)),
    (1, 591, 493, 149): ('C', ()),
    (1, 598, 499, 151): ('A', (427,)),
    (1, 627, 522, 333): ('C', ()),
    (1, 640, 533, 400): ('C', ()),
    (1, 709, 591, 178): ('C', ()),
    (1, 718, 598, 181): ('C', ()),
    (1, 752, 627, 400): ('A', (426,)),
    (1, 851, 709, 214): ('C', ()),
    (1, 862, 718, 218): ('C', ()),
    (1, 1022, 851, 257): ('C', ()),
    (1, 1034, 862, 261): ('C', ()),
    (1, 1226, 1022, 308): ('A', (426, 853)),
    (1, 1241, 1034, 313): ('C', ()),
}


def chain_mask(axis: int, m: int, n: int, other: int) -> np.ndarray:
    """(n,) bool: True where the output's taps take the chain form "A"."""
    base, exc = FORMS.get((axis, m, n, other), DEFAULT[axis])
    mask = np.full(n, base == "A")
    mask[list(exc)] = base != "A"
    return mask
