"""The port's two kernels (weiner_slamit_v2_torch/ops/fast_kernel.py,
ops/match_kernel.py): their plain PyTorch twins against the JAX package's
Pallas kernels (interpret mode) and XLA references, exact; the CUDA kernels
against the plain twins on a card (marked ``cuda``, skipped without one).

JAX is imported by a fixture, so the ``cuda`` cases also run on a machine
that has a card but no JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import types

import numpy as np
import pytest
import torch

from weiner_slamit_v2_torch.ops import fast_kernel, kernel_cases, match_kernel

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: jax, jnp, the XLA FAST ops and both Pallas kernels."""
    jax = pytest.importorskip("jax")
    from weiner_slamit_v2_tpu.ops import fast, fast_pallas, match_pallas

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, fast=fast,
        fast_score_nms_pallas=fast_pallas.fast_score_nms_pallas,
        windowed_best2_pallas=match_pallas.windowed_best2_pallas,
    )


def blob_image(h=160, w=256, seed=3):
    """Bright squares on a dark background (every square corner is a
    FAST-9 corner), as in tests/test_pallas.py."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 20.0, np.float32)
    for _ in range(40):
        y, x = rng.integers(8, h - 24), rng.integers(8, w - 24)
        s = rng.integers(6, 16)
        img[y : y + s, x : x + s] = 220.0
    return img


def fast_images():
    yy, xx = np.mgrid[0:128, 0:256]
    return {
        "texture": np.random.default_rng(0).uniform(0, 255, (192, 256)).astype(np.float32),
        "blobs": blob_image(),
        "checkerboard": (((yy // 12) + (xx // 12)) % 2).astype(np.float32) * 200.0,
        "nonmultiple_height": np.random.default_rng(1).uniform(0, 255, (150, 256)).astype(np.float32),
    }


@pytest.mark.parametrize("name", list(fast_images()))
def test_fast_plain_matches_jax(jx, name):
    img = fast_images()[name]
    xla = np.asarray(jx.fast.nms_3x3(jx.fast.fast_score(jx.jnp.asarray(img), 0.0)))
    pallas = np.asarray(jx.fast_score_nms_pallas(jx.jnp.asarray(img), interpret=True))
    port = fast_kernel.fast_score_nms(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(port, xla)
    np.testing.assert_array_equal(port, pallas)
    if name != "checkerboard":   # a perfect checkerboard has no FAST-9 corner
        assert (port > 0).sum() > 20


def frame_levels():
    """The 8-level pyramid of a 192x256 synthetic frame (levels 4-7 are
    narrower than 128 px) and a separate 5x6 level, too small to hold a pixel
    3 px from every border."""
    from weiner_slamit_v2_torch.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_torch.ops import pyramid

    img = make_synthetic_sequence(n_frames=2, h=192, w=256, seed=11, motion="orbit").frames[1].image
    img = torch.from_numpy(np.clip(img, 0, 255).astype(np.uint8)).float()
    tiny = np.random.default_rng(4).uniform(0, 255, (5, 6)).astype(np.float32)
    return [l.contiguous() for l in pyramid.build_pyramid(img, 8, 1.2)] + [torch.from_numpy(tiny)]


@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
def test_fast_levels_plain_matches_jax(jx, ref):
    """fast_score_nms_levels on CPU tensors, level for level, against the JAX
    package's XLA nms_3x3(fast_score(., 0)) and its Pallas kernel."""
    levels = frame_levels()
    outs = fast_kernel.fast_score_nms_levels(levels)
    assert len(outs) == len(levels)
    for img, out in zip(levels, outs):
        x = jx.jnp.asarray(img.numpy())
        if ref == "xla":
            want = jx.fast.nms_3x3(jx.fast.fast_score(x, 0.0))
        else:
            want = jx.fast_score_nms_pallas(x, interpret=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert all((o > 0).sum() > 20 for o in outs[:8])
    assert not outs[8].any()


def test_fast_levels_wrapper_contract():
    """One call per list; the single-image wrapper is the one-level case;
    bad inputs raise."""
    levels = frame_levels()[5:]
    for one, img in zip(fast_kernel.fast_score_nms_levels(levels), levels):
        assert torch.equal(one, fast_kernel.fast_score_nms(img))
    with pytest.raises(ValueError, match="levels"):
        fast_kernel.fast_score_nms_levels([])
    with pytest.raises(ValueError, match="levels"):
        fast_kernel.fast_score_nms_levels(levels * 6)
    with pytest.raises(ValueError, match="float32"):
        fast_kernel.fast_score_nms_levels([levels[0], levels[1].double()])


def test_extractor_runs_fast_once_per_frame(monkeypatch):
    """The extractor hands every level with a budget to one
    fast_score_nms_levels call per frame."""
    from weiner_slamit_v2_torch.config import OrbConfig
    from weiner_slamit_v2_torch.frontend import extractor

    calls = []

    def counting(levels):
        calls.append([tuple(l.shape) for l in levels])
        return fast_kernel.fast_score_nms_levels(levels)

    monkeypatch.setattr(extractor, "fast_score_nms_levels", counting)
    img = torch.from_numpy(blob_image(192, 256))
    ex = extractor.OrbExtractor(OrbConfig(n_features=256), (192, 256))
    feats = ex(img)
    assert len(calls) == 1 and len(calls[0]) == sum(b > 0 for b in ex.budgets) == 8
    assert int(feats.valid.sum()) > 20


def matcher_inputs(seed=0, N1=200, N2=300):
    """The inputs of tests/test_pallas.py::TestWindowedMatcherPallas."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 2**32, (N1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (N2, 8), dtype=np.uint32)
    v1, v2 = rng.random(N1) > 0.1, rng.random(N2) > 0.1
    px = rng.uniform(0, 320, (N1, 2)).astype(np.float32)
    x2 = rng.uniform(0, 320, (N2, 2)).astype(np.float32)
    win = rng.uniform(20, 120, (N1,)).astype(np.float32)
    lo = rng.integers(0, 3, N1).astype(np.int32)
    o2 = rng.integers(0, 6, N2).astype(np.int32)
    w2 = rng.uniform(0.3, 1.0, (N2,)).astype(np.float32)
    return d1, d2, v1, v2, px, x2, win, lo, lo + 2, o2, w2


def port_args(inp, B=1):
    """Batched torch arguments (B copies of the target) for windowed_best2."""
    d1, d2, v1, v2, px, x2, win, lo, hi, o2, w2 = inp
    t = lambda a: torch.from_numpy(np.stack([a] * B))  # noqa: E731
    return (t(d1.view(np.int32)), t(d2.view(np.int32)), t(v1), t(v2), t(px), t(x2),
            t(win), t(lo), t(hi), t(o2), t(w2))


@pytest.mark.parametrize("seed,chi2_th", [(0, 0.0), (5, 50.0)], ids=["no_chi2", "chi2_gate"])
def test_windowed_best2_plain_matches_pallas(jx, seed, chi2_th):
    inp = matcher_inputs(seed)
    d1, d2, v1, v2, px, x2, win, lo, hi, o2, w2 = (jx.jnp.asarray(a) for a in inp)
    ref = jx.windowed_best2_pallas(d1, d2, v1, v2, px, x2, win, lo, hi, o2,
                                chi2_w=w2, chi2_th=chi2_th, interpret=True)
    out = match_kernel.windowed_best2(*port_args(inp), chi2_th)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o[0].numpy(), np.asarray(r))
    assert (out[1] < 10_000).sum() > 20


def test_windowed_best2_rows_without_candidates(jx):
    """Rows that no column can pass (valid1 false, window <= 0 or NaN, a
    non-finite prediction) get the dense loop's fixed result (best_idx 0,
    best_dist 10000, second_dist 10000), in the port as in the Pallas kernel;
    the CUDA kernel writes it without any column work."""
    inp = list(matcher_inputs(3))
    inp[2] = inp[2].copy()
    inp[2][:20] = False
    inp[6] = inp[6].copy()
    inp[6][20:30], inp[6][30:40] = 0.0, np.nan
    inp[4] = inp[4].copy()
    inp[4][40:50, 0] = np.inf
    ref = jx.windowed_best2_pallas(*(jx.jnp.asarray(a) for a in inp[:10]), chi2_w=jx.jnp.asarray(inp[10]),
                                   chi2_th=50.0, interpret=True)
    out = match_kernel.windowed_best2(*port_args(tuple(inp)), 50.0)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o[0].numpy(), np.asarray(r))
    for o, fixed in zip(out, (0, 10_000, 10_000)):
        assert (o[0, :50] == fixed).all()
    assert (out[1][0, 50:] < 10_000).sum() > 20


def test_windowed_best2_plain_batched_over_targets(jx):
    """Three different targets in one batch vs the vmapped Pallas kernel
    (the fuse-targets pattern, tests/test_pallas.py:161-176)."""
    inps = [matcher_inputs(s) for s in (9, 10, 11)]
    d1, _, v1, _, px, _, win, lo, hi, _, _ = inps[0]
    cols = [np.stack([i[k] for i in inps]) for k in (1, 3, 5, 9, 10)]
    jnp = jx.jnp
    d2, v2, x2, o2, w2 = (jnp.asarray(c) for c in cols)
    ref = jx.jax.vmap(lambda dd, vv, xx, oo, ww: jx.windowed_best2_pallas(
        jnp.asarray(d1), dd, jnp.asarray(v1), vv, jnp.asarray(px), xx, jnp.asarray(win),
        jnp.asarray(lo), jnp.asarray(hi), oo, chi2_w=ww, chi2_th=50.0, interpret=True,
    ))(d2, v2, x2, o2, w2)
    a = list(port_args(inps[0], B=3))
    for slot, c in zip((1, 3, 5, 9, 10), cols):
        a[slot] = torch.from_numpy(c.view(np.int32) if c.dtype == np.uint32 else c)
    out = match_kernel.windowed_best2(*a, 50.0)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_wrappers_raise_on_bad_dtype():
    with pytest.raises(ValueError, match="float32"):
        fast_kernel.fast_score_nms(torch.zeros((16, 16), dtype=torch.float64))
    a = list(port_args(matcher_inputs()))
    a[0] = a[0].to(torch.int64)
    with pytest.raises(ValueError, match="desc1"):
        match_kernel.windowed_best2(*a, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (231, 309), (134, 179), (150, 256)])
def test_fast_kernel_matches_plain_on_card(cuda_device, shape):
    img = torch.from_numpy(np.random.default_rng(2).uniform(0, 255, shape).astype(np.float32))
    img = img.to(cuda_device)
    before = fast_kernel.launches
    out = fast_kernel.fast_score_nms(img)
    torch.cuda.synchronize()
    assert fast_kernel.launches == before + 1
    assert torch.equal(out, fast_kernel.fast_score_nms_plain(img))
    with pytest.raises(ValueError):
        fast_kernel.fast_score_nms(img.double())


@pytest.mark.cuda
@pytest.mark.parametrize("B,N1,N2,th", [(20, 1024, 1024, 5.991), (3, 1000, 777, 0.0)])
def test_windowed_best2_kernel_matches_plain_on_card(cuda_device, B, N1, N2, th):
    rng = np.random.default_rng(B)
    inp = matcher_inputs(seed=B, N1=N1, N2=N2)
    args = [a.to(cuda_device).contiguous() for a in port_args(inp, B)]
    args[5] = args[5] + torch.from_numpy(rng.normal(0, 3, (B, N2, 2)).astype(np.float32)).to(cuda_device)
    before = match_kernel.launches
    out = match_kernel.windowed_best2(*args, th)
    torch.cuda.synchronize()
    assert match_kernel.launches == before + 1
    for o, r in zip(out, match_kernel.windowed_best2_plain(*args, th)):
        assert torch.equal(o, r)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["640x480_pyramid", "ragged", "constant", "checkerboard_plateau"])
def test_fast_levels_kernel_one_launch_on_card(cuda_device, name):
    """All levels in one launch, bit-equal to the plain version level by level."""
    if name == "640x480_pyramid":
        from weiner_slamit_v2_torch.io.datasets import make_synthetic_sequence
        from weiner_slamit_v2_torch.ops import pyramid

        img = make_synthetic_sequence(n_frames=2, h=480, w=640, seed=0, motion="orbit").frames[1].image
        img = torch.from_numpy(np.clip(img, 0, 255).astype(np.uint8)).to(cuda_device).float()
        levels = [l.contiguous() for l in pyramid.build_pyramid(img, 8, 1.2)]
    else:
        levels = kernel_cases.fast_level_sets(cuda_device)[name]
    before = fast_kernel.launches
    outs = fast_kernel.fast_score_nms_levels(levels)
    torch.cuda.synchronize()
    assert fast_kernel.launches == before + 1
    for lvl, (out, ref) in enumerate(zip(outs, fast_kernel.fast_score_nms_levels_plain(levels))):
        assert torch.equal(out, ref), (name, lvl, tuple(out.shape), int((out != ref).sum()))


@pytest.mark.cuda
def test_windowed_best2_kernel_adversarial_on_card(cuda_device):
    """The binned kernel against the plain version on the edge cases of
    ops/kernel_cases.py (cell borders, |du| == win, windows <= 0 / NaN /
    inf, non-finite predictions and columns, columns outside the image, all
    rows or all columns invalid, duplicate columns, N2 in {1, 300, 777, 1024,
    5000}, chi2 gate on and off)."""
    for name, args, th in kernel_cases.matcher_cases(cuda_device):
        out = match_kernel.windowed_best2(*args, th)
        ref = match_kernel.windowed_best2_plain(*args, th)
        torch.cuda.synchronize()
        for field, o, r in zip(("best_idx", "best_dist", "second_dist"), out, ref):
            assert torch.equal(o, r), (name, field, int((o != r).sum()))
        if name.startswith("all_rows_invalid"):
            for o, fixed in zip(out, (0, 10_000, 10_000)):
                assert (o == fixed).all()
