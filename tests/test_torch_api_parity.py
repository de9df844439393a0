"""The port's public surface against the JAX package's.

``test_every_public_name_has_a_counterpart`` parses both packages with
``ast`` (nothing is imported): every public top-level name and every public
method of each JAX module has a counterpart in the port module at the same
path, or stands in ``EXCLUDED`` with its reason. The other tests hold the
small helpers against the JAX functions on seeded numpy inputs: integers
exactly, floats bit for bit where both sides round the same, else to the
stated tolerance.
"""

import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weiner_slamit_v2_tpu import config as jconfig
from weiner_slamit_v2_tpu.frontend import extractor as jextractor
from weiner_slamit_v2_tpu.frontend import initializer as jinit
from weiner_slamit_v2_tpu.geometry import epipolar as jepipolar
from weiner_slamit_v2_tpu.geometry import se3 as jse3
from weiner_slamit_v2_tpu.geometry import sim3 as jsim3
from weiner_slamit_v2_tpu.ops import hamming as jhamming
from weiner_slamit_v2_tpu.optim import pose_opt as jpose_opt
from weiner_slamit_v2_tpu.parallel import sharded_ba as jsharded
from weiner_slamit_v2_tpu.slam_map import types as jtypes
from weiner_slamit_v2_torch import config as tconfig
from weiner_slamit_v2_torch.frontend import extractor, initializer
from weiner_slamit_v2_torch.geometry import epipolar, se3, sim3
from weiner_slamit_v2_torch.ops import hamming
from weiner_slamit_v2_torch.optim import pose_opt
from weiner_slamit_v2_torch.parallel import sharded_ba
from weiner_slamit_v2_torch.slam_map import types
from weiner_slamit_v2_torch.slam_map.convert import map_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "weiner_slamit_v2_tpu", ROOT / "weiner_slamit_v2_torch"

# "module path" (the whole module) or "module path::Name": the JAX names
# that cannot have a counterpart at the same path, each with its reason.
EXCLUDED = {
    "ops/fast_pallas.py": "the Pallas kernel A (HALO, use_pallas_default included); the port's is "
                          "ops/fast_kernel.py + csrc/fast_score_nms.cu",
    "ops/match_pallas.py": "the Pallas kernel B; the port's is ops/match_kernel.py + "
                           "csrc/windowed_best2.cu",
    "tracking/tracker.py::TrackParams": "a pytree of traced scalars for jit; the port reads cfg",
    "tracking/tracker.py::TrackParams.from_config": "TrackParams' constructor (see TrackParams)",
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _jax_names(tree: ast.Module) -> set[str]:
    """Public top-level functions, classes and assignments, and the public
    methods of public classes."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not _public(node.name):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(m.name)}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out |= {t.id for t in targets if isinstance(t, ast.Name) and _public(t.id)}
    return out


def _port_names(tree: ast.Module) -> set[str]:
    """What a port module offers under a name: the same kinds as
    ``_jax_names``, plus imported names, and for a class its fields and the
    attributes its methods set on ``self`` (the counterpart of a property)."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.add(f"{node.name}.{m.name}")
                    out |= {f"{node.name}.{t.attr}" for sub in ast.walk(m)
                            if isinstance(sub, (ast.Assign, ast.AnnAssign))
                            for t in (sub.targets if isinstance(sub, ast.Assign) else [sub.target])
                            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                            and t.value.id == "self"}
                elif isinstance(m, ast.AnnAssign) and isinstance(m.target, ast.Name):
                    out.add(f"{node.name}.{m.target.id}")
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out |= {t.id for t in targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
    return out


def _parse(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _jax_surface() -> dict[str, set[str]]:
    return {str(p.relative_to(JAX_PKG)): _jax_names(_parse(p)) for p in sorted(JAX_PKG.rglob("*.py"))}


def test_every_public_name_has_a_counterpart():
    missing = []
    for mod, names in _jax_surface().items():
        if mod in EXCLUDED:
            continue
        port = PORT_PKG / mod
        have = _port_names(_parse(port)) if port.exists() else set()
        missing += [f"{mod}::{n}" for n in sorted(names)
                    if n not in have and f"{mod}::{n}" not in EXCLUDED]
    assert not missing, f"JAX names with no port counterpart and no exclusion: {missing}"


def test_exclusions_are_needed_and_explained():
    """Each exclusion names a JAX module or name that exists and that the
    port really lacks at that path, with a one-line reason."""
    surface = _jax_surface()
    for key, reason in EXCLUDED.items():
        assert reason.strip() and "\n" not in reason, key
        mod, _, name = key.partition("::")
        assert mod in surface, key
        port = PORT_PKG / mod
        if not name:
            assert not port.exists(), f"{key}: the port has this module"
            continue
        assert name in surface[mod], key
        assert not port.exists() or name not in _port_names(_parse(port)), f"{key}: the port has it"


def test_the_walk_sees_methods_and_attributes():
    tree = ast.parse(
        "from a import B as C\nX = 1\n_y = 2\n"
        "class P:\n  f: int\n  def __init__(self):\n    self.z = 1\n  def g(self):\n    pass\n"
        "  def _h(self):\n    pass\n")
    assert _jax_names(tree) == {"X", "P", "P.g"}
    assert {"C", "X", "P", "P.f", "P.z", "P.g"} <= _port_names(tree)


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def test_hamming_distance_and_mutual_best():
    rng = np.random.default_rng(0)
    a, b = _desc(rng, 64), _desc(rng, 64)
    b[::3] = a[::3] ^ (1 << rng.integers(0, 32, (22, 8))).astype(np.uint32)   # near matches
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    np.testing.assert_array_equal(hamming.hamming_distance(ta, tb).numpy(),
                                  np.asarray(jhamming.hamming_distance(jnp.asarray(a), jnp.asarray(b))))
    # a distance matrix with ties and invalid rows (ties go to the lower index)
    dist = rng.integers(0, 40, (48, 56)).astype(np.int32)
    dist[5] = jhamming.INVALID_DIST
    dist[:, 7] = dist[:, 3]
    jm, jb = jhamming.mutual_best(jnp.asarray(dist))
    tm, tbest = hamming.mutual_best(torch.from_numpy(dist))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tbest.numpy(), np.asarray(jb))
    assert (tm.numpy() >= 0).sum() > 5 and tm.dtype == torch.int32


def test_epipolar_dist_sq():
    rng = np.random.default_rng(1)
    T1 = np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.1, 6), jnp.float32)))
    T2 = np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.1, 6), jnp.float32)))
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    F = np.asarray(jepipolar.fundamental_from_poses(jnp.asarray(T1), jnp.asarray(T2), K, K))
    uv1 = rng.uniform(0, 320, (200, 2)).astype(np.float32)
    uv2 = rng.uniform(0, 320, (200, 2)).astype(np.float32)
    want = np.asarray(jepipolar.epipolar_dist_sq(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(F)))
    got = epipolar.epipolar_dist_sq(torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(F.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    # batched F, and a point on its own epipolar line
    Fb = np.broadcast_to(F, (200, 3, 3))
    got_b = epipolar.epipolar_dist_sq(torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(Fb.copy()))
    np.testing.assert_array_equal(got_b.numpy(), got.numpy())


def test_identity_and_compose():
    rng = np.random.default_rng(2)
    A = np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.3, (5, 6)), jnp.float32)))
    B = np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.3, (5, 6)), jnp.float32)))
    np.testing.assert_allclose(se3.compose(torch.from_numpy(A), torch.from_numpy(B)).numpy(),
                               np.asarray(jse3.compose(jnp.asarray(A), jnp.asarray(B))), atol=1e-6)
    for port_mod, jax_mod in ((se3, jse3), (sim3, jsim3)):
        for dt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float32)):
            eye = port_mod.identity(dt)
            assert eye.dtype == dt and eye.device.type == "cpu"
            np.testing.assert_array_equal(eye.numpy(), np.asarray(jax_mod.identity(jdt)))
    np.testing.assert_array_equal(sim3.compose(sim3.identity(), torch.from_numpy(A)).numpy(), A)


def test_recount_observations():
    cap = jconfig.MapCapacityConfig(max_keyframes=8, max_map_points=64, max_obs_per_point=4,
                                    local_ba_window=4, local_ba_points=32)
    jm = jtypes.empty_map(cap, 20)
    rng = np.random.default_rng(3)
    kf_obs = np.where(rng.random((8, 20)) < 0.6, rng.integers(0, 64, (8, 20)), -1).astype(np.int32)
    jm = jm.replace(kf_obs=jnp.asarray(kf_obs),
                    kf_feat_valid=jnp.asarray(rng.random((8, 20)) < 0.9),
                    kf_valid=jnp.asarray(np.arange(8) != 2))
    arrays = {f.name: np.asarray(getattr(jm, f.name)) for f in dataclasses.fields(jm)}
    tm = map_from_numpy(arrays, device="cpu")
    got = types.recount_observations(tm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtypes.recount_observations(jm)))


def test_get_extractor_is_cached():
    cfg = tconfig.OrbConfig(n_features=256)
    ex = extractor.get_extractor(cfg, (120, 160))
    assert ex is extractor.get_extractor(cfg, (120, 160))
    assert ex is not extractor.get_extractor(cfg, (240, 320))
    jex = jextractor.get_extractor(jconfig.OrbConfig(n_features=256), (120, 160))
    assert ex.budgets == jex.budgets and ex.n_total == jex.n_total
    np.testing.assert_array_equal(ex.scales, np.asarray(jex.scales))


@pytest.mark.parametrize("name, port_mod, jax_mod", [
    ("HUBER_MONO", pose_opt, jpose_opt),
    ("CHI2_MONO", pose_opt, jpose_opt),
    ("SIGMA", initializer, jinit),
    ("CHI2_MONO", sharded_ba, jsharded),
])
def test_constants(name, port_mod, jax_mod):
    assert getattr(port_mod, name) == getattr(jax_mod, name)
