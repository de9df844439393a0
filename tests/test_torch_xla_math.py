"""ops/xla_math.py against the reference: ``atan2``, ``sin`` and ``cos``
bit for bit against jitted ``jnp.arctan2``, ``jnp.sin`` and ``jnp.cos`` on the
CPU (XLA:CPU calls the C library's ``atan2f`` and ``sincosf``), over dense
float32 grids (zeros of both signs, subnormals, infinities, NaN, the
quadrant edges, the thresholds where either function changes its
reduction, a sweep of every 8192nd bit pattern) and 100,000 random values.
The ``cuda`` cases hold the card's results against the CPU port's on the
same grids; they import no JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_xla_math.py
"""

import numpy as np
import pytest
import torch

from weiner_slamit_v2_torch.ops import xla_math


def _around(values, ulps=8) -> np.ndarray:
    """Each float32 value and its neighbours within ``ulps`` units."""
    bits = np.asarray(values, np.float32).view(np.int32).astype(np.int64)
    near = (bits[:, None] + np.arange(-ulps, ulps + 1)[None, :]).ravel()
    return near[(near >= -(2**31)) & (near < 2**31)].astype(np.int32).view(np.float32)


def grid() -> np.ndarray:
    """Dense float32 arguments, both signs."""
    specials = np.array([0.0, np.inf, np.nan, 1.0, np.finfo(np.float32).max,
                         np.finfo(np.float32).tiny], np.float32)
    subnormal = np.arange(1, 1 << 23, 4099, dtype=np.int32).view(np.float32)
    quadrants = np.float32(np.pi / 4) * np.arange(0, 200, dtype=np.float32)
    # where sincosf changes its reduction and atanf its interval
    thresholds = np.array([0.75, 120.0, 2.0**-12, 2.0**-126, 7 / 16, 11 / 16, 19 / 16, 39 / 16,
                           2.0**-29, 2.0**25, 2.0**34, 2.0**60], np.float32)
    sweep = np.arange(0, 0x7F800000, 8192, dtype=np.int64).astype(np.int32).view(np.float32)
    pos = np.concatenate([specials, subnormal, _around(quadrants), _around(thresholds), sweep])
    return np.concatenate([pos, -pos])


def random_values(n=100_000, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(-np.pi, np.pi, n // 2),
        rng.choice([-1.0, 1.0], n - n // 2) * 10.0 ** rng.uniform(-40, 38, n - n // 2),
    ]).astype(np.float32)


def atan2_pairs(seed=1) -> tuple[np.ndarray, np.ndarray]:
    """(y, x): every pair of a special set, rays at dense angles through all
    four quadrants and the reduction edges, exponent gaps around 2**60, and
    100,000 random pairs."""
    rng = np.random.default_rng(seed)
    sp = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 2.0, -0.5, 1e-45, -1e-45,
                   1e-38, 3e38, -3e38], np.float32)
    yy, xx = np.meshgrid(sp, sp)
    theta = np.linspace(-np.pi, np.pi, 20_001, dtype=np.float64)
    r = 10.0 ** rng.uniform(-3, 3, theta.size)
    ray_y, ray_x = (r * np.sin(theta)).astype(np.float32), (r * np.cos(theta)).astype(np.float32)
    edges = _around(np.array([7 / 16, 11 / 16, 19 / 16, 39 / 16, 1.0, 2.0**25], np.float32), 16)
    gap = np.float32(2.0) ** np.arange(-70, 71, dtype=np.float32)
    n = 100_000
    ry = (rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)).astype(np.float32)
    rx = (rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)).astype(np.float32)
    y = np.concatenate([yy.ravel(), ray_y, edges, -edges, gap, -gap, ry])
    x = np.concatenate([xx.ravel(), ray_x, np.ones_like(edges), -np.ones_like(edges),
                        np.ones_like(gap), -np.ones_like(gap), rx])
    return y.astype(np.float32), x.astype(np.float32)


def assert_same_bits(a: np.ndarray, b: np.ndarray):
    """Equal bit patterns, NaNs of any payload counted equal."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))
    bad = np.flatnonzero(~same)
    assert bad.size == 0, f"{bad.size} differ, e.g. at {bad[:5]}: {a[bad[:5]]} vs {b[bad[:5]]}"


@pytest.mark.parametrize("values", ["grid", "random"])
def test_sin_cos_equal_xla(values):
    import jax
    import jax.numpy as jnp

    v = grid() if values == "grid" else random_values()
    # the descriptor program computes both of one argument (one sincosf);
    # alone, each is the same function's half
    js, jc = jax.jit(lambda x: (jnp.sin(x), jnp.cos(x)))(v)
    s, c = xla_math.sincos(torch.from_numpy(v))
    assert_same_bits(s.numpy(), np.asarray(js))
    assert_same_bits(c.numpy(), np.asarray(jc))
    assert_same_bits(xla_math.sin(torch.from_numpy(v)).numpy(), np.asarray(jax.jit(jnp.sin)(v)))
    assert_same_bits(xla_math.cos(torch.from_numpy(v)).numpy(), np.asarray(jax.jit(jnp.cos)(v)))


@pytest.mark.parametrize("values", ["grid", "random"])
def test_atan2_equal_xla(values):
    import jax
    import jax.numpy as jnp

    if values == "grid":
        y, x = atan2_pairs()
    else:
        y, x = random_values(seed=2), random_values(seed=3)
    ref = np.asarray(jax.jit(jnp.arctan2)(y, x))
    assert_same_bits(xla_math.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy(), ref)


def test_torch_functions_differ():
    """Why the module exists: torch's own functions part from XLA's on
    some arguments (an ulp at a time)."""
    v = random_values()
    y, x = random_values(seed=2), random_values(seed=3)
    s, c = xla_math.sincos(torch.from_numpy(v))
    a = xla_math.atan2(torch.from_numpy(y), torch.from_numpy(x))
    differ = [(torch.sin(torch.from_numpy(v)) != s).sum(), (torch.cos(torch.from_numpy(v)) != c).sum(),
              (torch.atan2(torch.from_numpy(y), torch.from_numpy(x)) != a).sum()]
    assert all(int(d) > 0 for d in differ), differ


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["grid", "random"])
def test_card_equals_cpu(values):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    v = grid() if values == "grid" else random_values()
    y, x = atan2_pairs() if values == "grid" else (random_values(seed=2), random_values(seed=3))
    for cpu, card in zip(xla_math.sincos(torch.from_numpy(v)), xla_math.sincos(torch.from_numpy(v).cuda())):
        assert_same_bits(card.cpu().numpy(), cpu.numpy())
    assert_same_bits(xla_math.atan2(torch.from_numpy(y).cuda(), torch.from_numpy(x).cuda()).cpu().numpy(),
                     xla_math.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy())
