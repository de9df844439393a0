"""Measure how XLA:CPU sums the two taps of every linear resize of the image
pyramid, at every image size the repo ships, and print the table that
weiner_slamit_v2_torch/ops/resize_forms.py holds.

    JAX_PLATFORMS=cpu python tools/resize_forms_torch.py [--trials 4] [--sizes 240x320 ...]
        [--check]

jax.image.resize(linear, antialias=False) is two dot products per level, a
row pass and a column pass, each over the whole weight matrix (two nonzero
taps per output, the rest zeros). XLA:CPU hands each dot to its GEMM
library, and which of two forms an output takes depends on how that
library blocks the dot: one fused multiply-add chain,
``fma(w1, x1, w0 * x0)`` (form "A"), or two rounded products summed,
``w0 * x0 + w1 * x1`` (form "C"). A dot takes one form for all outputs,
except the outputs whose two taps straddle one of the library's K-block
edges, which take the other. The tool runs each pass as its own jitted
resize on random images (the same dot shapes as the tracker's compiled
extract program; the flags of tests/conftest.py), classifies every output,
and prints, per pass, the base form and the outputs that differ from it.
An output whose candidates agree on every trial tells nothing; --trials
sets how many random images to use. --check compares the port's pyramid
with the JAX one at every size instead.

The table belongs to this jax/jaxlib, its GEMM library and an XLA:CPU
thread pool of 8 threads (the pool's size changes the blocking): after an
upgrade, rerun this tool and tests/test_torch_frontend.py.
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from weiner_slamit_v2_torch.ops import pyramid  # noqa: E402
from weiner_slamit_v2_torch.ops.resize_forms import SHIPPED_SIZES  # noqa: E402


def _fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _forms(x, out, axis):
    """(n, other) bit masks of the forms each output of one pass matches:
    1 chain "A", 2 "C" (two products summed)."""
    m, n = x.shape[axis], out.shape[axis]
    i0, i1, w0, w1 = pyramid._taps(m, n)
    if axis == 1:
        x, out = x.T, out.T
    x0, x1 = x[i0], x[i1]
    p0 = (x0 * w0[:, None]).astype(np.float32)
    p1 = (x1 * w1[:, None]).astype(np.float32)
    a = _fma(w1[:, None], x1, p0)
    c = (p0 + p1).astype(np.float32)
    return (a == out) * 1 + (c == out) * 2


def classify(h: int, w: int, trials: int):
    """{(axis, m, n, other): (base, exceptions)} for the 7 resizes of (h, w)."""
    shapes = pyramid.level_shapes(h, w, 8, 1.2)
    rng = np.random.default_rng(1)
    imgs = [rng.uniform(0, 255, (h, w)).astype(np.float32) for _ in range(trials)]
    table = {}
    for lvl in range(1, 8):
        (hh, ww), (h2, w2) = shapes[lvl - 1], shapes[lvl]
        rows_fn = jax.jit(lambda v: jax.image.resize(v, (h2, ww), "linear", antialias=False))
        both_fn = jax.jit(lambda v: jax.image.resize(v, (h2, w2), "linear", antialias=False))
        masks = {0: 3, 1: 3}
        nxt = []
        for img in imgs:
            rows, both = np.asarray(rows_fn(img)), np.asarray(both_fn(img))
            masks[0] = masks[0] & _forms(img, rows, 0)
            masks[1] = masks[1] & _forms(rows, both, 1)
            nxt.append(both)
        for axis, key in ((0, (0, hh, h2, ww)), (1, (1, ww, w2, h2))):
            mk = masks[axis]
            if (mk == 0).any():
                raise SystemExit(f"{key}: outputs match neither form; the weights differ")
            a_only = ((mk == 1).sum(1) > 0)
            c_only = ((mk == 2).sum(1) > 0)
            if (a_only & c_only).any():
                raise SystemExit(f"{key}: an output takes both forms along the other axis")
            base = "A" if a_only.sum() >= c_only.sum() else "C"
            exc = np.flatnonzero(c_only if base == "A" else a_only)
            table[key] = (base, tuple(int(j) for j in exc))
        imgs = nxt
    return table


def check(h: int, w: int) -> list[int]:
    """Pixels per level where the port's pyramid differs from the jitted JAX one."""
    import torch

    from weiner_slamit_v2_tpu.ops import pyramid as jpyramid

    img = np.random.default_rng(2).integers(0, 256, (h, w)).astype(np.uint8)
    jl = jax.jit(lambda x: jpyramid.build_pyramid(x.astype(jnp.float32), 8, 1.2))(jnp.asarray(img))
    tl = pyramid.build_pyramid(torch.from_numpy(img).float(), 8, 1.2)
    return [int((np.asarray(a) != b.numpy()).sum()) for a, b in zip(jl, tl)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--sizes", nargs="*", default=[f"{h}x{w}" for h, w in SHIPPED_SIZES])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    sizes = [tuple(int(v) for v in s.split("x")) for s in args.sizes]
    if args.check:
        for h, w in sizes:
            print(f"{h}x{w}: differing pixels per level {check(h, w)}")
        return
    table = {}
    for h, w in sizes:
        table.update(classify(h, w, args.trials))
    print("FORMS = {")
    for key in sorted(table):
        print(f"    {key}: {table[key]!r},")
    print("}")


if __name__ == "__main__":
    main()
