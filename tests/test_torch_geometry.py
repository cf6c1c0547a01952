"""The port's geometry package (``gcanet_tpu_torch/geometry``) against the
JAX package's on the same seeded numpy inputs.

Tolerances:
  * distances and affinities: rtol=1e-5, atol=1e-6 (fp32 in another order);
  * fits: rtol=1e-4, atol=1e-5 (a 3x3 eigh or a small solve in fp32, in
    another LAPACK path); normals and axes up to sign, since eigh may return
    either; every test input has eigenvalue gaps above 1e-3;
  * gradients through the guarded eigh: rtol=1e-4, atol=1e-5 x the largest
    entry of the JAX gradient, of losses that do not see the eigenvector's
    sign; one degenerate input (two equal eigenvalues) where both sides are
    finite;
  * splines: the numpy basis functions bit for bit; the device solves,
    sampling and ARAP at rtol=1e-4, atol=1e-5 of the largest entry
    (float32 normal equations of up to 420 unknowns, in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcanet_tpu.geometry import affinity as jaff
from gcanet_tpu.geometry import fit_circle as jcircle
from gcanet_tpu.geometry import fitting as jfit
from gcanet_tpu.geometry import primitive_dis as jdis
from gcanet_tpu.geometry import spline as jspline
from gcanet_tpu_torch.geometry import affinity as taff
from gcanet_tpu_torch.geometry import fit_circle as tcircle
from gcanet_tpu_torch.geometry import fitting as tfit
from gcanet_tpu_torch.geometry import primitive_dis as tdis
from gcanet_tpu_torch.geometry import spline as tspline
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

DIST = dict(rtol=1e-5, atol=1e-6)
FIT = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-4, 1e-5


def _jit(fn, **static):
    """The JAX function compiled once as a whole (eager JAX compiles each
    op, which costs more here)."""
    return jax.jit(functools.partial(fn, **static))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want), **tol)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _params(rng, m):
    """Per-type parameter rows: plane (normal, offset), sphere (center,
    radius), cylinder (axis, center, radius), cone (apex, axis, theta)."""
    return {
        1: np.concatenate([_unit(rng.randn(m, 3)), rng.randn(m, 1)], 1).astype(np.float32),
        5: np.concatenate([rng.randn(m, 3), rng.rand(m, 1) + 0.2], 1).astype(np.float32),
        4: np.concatenate([_unit(rng.randn(m, 3)), rng.randn(m, 3), rng.rand(m, 1) + 0.2],
                          1).astype(np.float32),
        3: np.concatenate([rng.randn(m, 3), _unit(rng.randn(m, 3)), rng.rand(m, 1) + 0.2],
                          1).astype(np.float32),
    }


# ------------------------------------------------------------ distances

@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("typ", [1, 5, 4, 3])
def test_primitive_distances(typ, sqrt):
    rng = np.random.RandomState(typ)
    pts = rng.randn(50, 3).astype(np.float32)
    params = _params(rng, 7)[typ]
    assert tdis.ROUTINES.keys() == jdis.ROUTINES.keys()
    want = _jit(jdis.ROUTINES[typ], sqrt=sqrt)(pts, params)
    got = tdis.ROUTINES[typ](_t(pts), _t(params), sqrt=sqrt)
    assert got.shape == (50, 7)
    _close(got, want, **DIST)


@pytest.mark.parametrize("sqrt", [False, True])
def test_torus_bspline_chamfer_guard_sqrt(sqrt):
    rng = np.random.RandomState(11)
    pts = rng.randn(40, 3).astype(np.float32)
    torus = (_unit(rng.randn(3)), rng.randn(3).astype(np.float32), np.float32(1.2),
             np.float32(0.3))
    _close(tdis.distance_from_torus(_t(pts), tuple(_t(p) for p in torus), sqrt=sqrt),
           jdis.distance_from_torus(jnp.asarray(pts), tuple(jnp.asarray(p) for p in torus),
                                    sqrt=sqrt), **DIST)
    surf = rng.randn(90, 3).astype(np.float32)
    _close(tdis.distance_from_bspline(_t(pts), _t(surf), sqrt=sqrt),
           jdis.distance_from_bspline(jnp.asarray(pts), jnp.asarray(surf), sqrt=sqrt), **DIST)
    _close(tdis.chamfer_distance_one_side(_t(surf), _t(pts), sqrt=sqrt),
           jdis.chamfer_distance_one_side(jnp.asarray(surf), jnp.asarray(pts), sqrt=sqrt),
           **DIST)
    x = np.array([0.0, 1e-7, 1e-5, 0.5, 4.0], np.float32)
    _close(tdis.guard_sqrt(_t(x)), jdis.guard_sqrt(jnp.asarray(x)), **DIST)


# ------------------------------------------------------------ circles

@pytest.mark.parametrize("case", ["generic", "same", "opposite"])
def test_rodrigues_rot(case):
    rng = np.random.RandomState(12)
    p = rng.randn(20, 3).astype(np.float32)
    n0 = rng.randn(3).astype(np.float32)
    n1 = {"generic": rng.randn(3).astype(np.float32), "same": 2.0 * n0, "opposite": -n0}[case]
    _close(tcircle._rodrigues_rot(_t(p), _t(n0), _t(n1)),
           jcircle._rodrigues_rot(jnp.asarray(p), jnp.asarray(n0), jnp.asarray(n1)), **FIT)


def test_fit_circle_2d_and_3d():
    rng = np.random.RandomState(4)
    t = rng.uniform(0, 2 * np.pi, 100)
    x = (0.6 * np.cos(t) + 1.0 + 0.01 * rng.randn(100)).astype(np.float32)
    y = (0.6 * np.sin(t) - 2.0).astype(np.float32)
    for g, w in zip(tcircle.fit_circle_2d(_t(x), _t(y)), _jit(jcircle.fit_circle_2d)(x, y)):
        _close(g, w, **FIT)
    rot = np.linalg.qr(rng.randn(3, 3))[0]
    pts = (np.stack([x, y, 0.02 * rng.randn(100)], 1) @ rot.T).astype(np.float32)
    center, r = tcircle.fit_circle_3d(_t(pts))
    want_c, want_r = _jit(jcircle.fit_circle_3d)(pts)
    _close(center, want_c, **FIT)
    _close(r, want_r, **FIT)


# ------------------------------------------------------------ fits

def _cloud(seed):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(120, 3) * [1.0, 0.6, 0.2]).astype(np.float32)
    nrm = _unit(rng.randn(120, 3) * [0.3, 0.5, 1.0])
    w = rng.uniform(0.2, 1.0, (120, 1)).astype(np.float32)
    return pts, nrm, w


def _same_up_to_sign(got, want):
    got, want = np.asarray(got.detach()), np.asarray(want)
    sign = np.sign(np.sum(got * want))
    np.testing.assert_allclose(sign * got, want, **FIT)
    return sign


def test_lstsq_and_smallest_right_singular():
    pts, nrm, w = _cloud(0)
    y = np.random.RandomState(1).randn(120, 1).astype(np.float32)
    _close(tfit.lstsq(_t(pts), _t(y), 1e-3), _jit(jfit.lstsq, lamb=1e-3)(pts, y), **FIT)
    _same_up_to_sign(tfit.smallest_right_singular(_t(w * nrm)),
                     _jit(jfit.smallest_right_singular)(w * nrm))


def test_fit_plane_sphere():
    pts, _, w = _cloud(2)
    a, d = tfit.fit_plane(_t(pts), _t(w))
    want_a, want_d = _jit(jfit.fit_plane)(pts, w)
    sign = _same_up_to_sign(a, want_a)
    _close(sign * d, want_d, **FIT)
    for g, want in zip(tfit.fit_sphere(_t(pts), _t(w)), _jit(jfit.fit_sphere)(pts, w)):
        _close(g, want, **FIT)


def test_fit_cylinder_cone():
    rng = np.random.RandomState(3)
    theta = rng.uniform(0, 2 * np.pi, 300)
    h = rng.uniform(-1, 1, 300)
    pts = np.stack([0.4 * np.cos(theta), 0.4 * np.sin(theta), h], 1)
    nrm = np.stack([np.cos(theta), np.sin(theta), np.zeros(300)], 1)
    rot = np.linalg.qr(rng.randn(3, 3))[0]
    pts = (pts @ rot.T + 0.01 * rng.randn(300, 3)).astype(np.float32)
    nrm = _unit(nrm @ rot.T + 0.02 * rng.randn(300, 3))
    w = rng.uniform(0.5, 1.0, (300, 1)).astype(np.float32)
    a, center, radius = tfit.fit_cylinder(_t(pts), _t(nrm), _t(w))
    want_a, want_c, want_r = _jit(jfit.fit_cylinder)(pts, nrm, w)
    _same_up_to_sign(a, want_a)
    _close(center, want_c, **FIT)
    _close(radius, want_r, **FIT)

    t = rng.uniform(0.2, 1.0, 300)
    pts = np.stack([t * np.tan(0.5) * np.cos(theta), t * np.tan(0.5) * np.sin(theta), t], 1)
    nrm = np.stack([np.cos(0.5) * np.cos(theta), np.cos(0.5) * np.sin(theta),
                    np.full(300, -np.sin(0.5))], 1)
    pts = (pts + 0.01 * rng.randn(300, 3)).astype(np.float32)
    nrm = _unit(nrm + 0.02 * rng.randn(300, 3))
    for g, want in zip(tfit.fit_cone(_t(pts), _t(nrm), _t(w)), _jit(jfit.fit_cone)(pts, nrm, w)):
        _close(g, want, **FIT)


def _hold_grads(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all() and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SHARE * np.abs(w).max())


_M = np.random.RandomState(9).randn(3, 3).astype(np.float32)


def _plane_loss(fit, lib):
    def loss(pts, w):
        a, d = fit(pts, w)
        return lib.sum((a.T @ a) * _M_of(lib)) + d * d
    return loss


def _M_of(lib):
    return jnp.asarray(_M) if lib is jnp else _t(_M)


def _grads_torch(loss, *arrays):
    ts = [_t(a).requires_grad_() for a in arrays]
    loss(*ts).backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("case", ["generic", "degenerate"])
def test_fit_plane_gradient(case):
    if case == "generic":
        pts, _, w = _cloud(5)
    else:
        # a regular point set in the plane z = 2: the eigenvalues are
        # exactly (0, 6, 6), so the guard's clamped gap meets the equal pair
        xy = np.array([[1, 0], [-1, 0], [0, 1], [0, -1], [1, 1], [1, -1], [-1, 1], [-1, -1]])
        pts = np.concatenate([xy, np.full((8, 1), 2.0)], 1).astype(np.float32)
        w = np.ones((8, 1), np.float32)
    want = jax.jit(jax.grad(_plane_loss(jfit.fit_plane, jnp), argnums=(0, 1)))(pts, w)
    _hold_grads(_grads_torch(_plane_loss(tfit.fit_plane, torch), pts, w), want)


def test_fit_cylinder_and_eigh_gradient():
    pts, nrm, w = _cloud(6)

    def cyl_loss(fit, lib):
        def loss(p, n, w):
            a, center, radius = fit(p, n, w)
            return lib.sum((a @ a.T) * _M_of(lib)) + lib.sum(center * center) + radius
        return loss

    want = jax.jit(jax.grad(cyl_loss(jfit.fit_cylinder, jnp), argnums=(0, 1, 2)))(pts, nrm, w)
    _hold_grads(_grads_torch(cyl_loss(tfit.fit_cylinder, torch), pts, nrm, w), want)

    def eig_loss(srs, lib):
        def loss(a):
            v = srs(a)
            return lib.sum(v[:, None] * v[None, :] * _M_of(lib))
        return loss

    want = jax.jit(jax.grad(eig_loss(jfit.smallest_right_singular, jnp)))(w * nrm)
    _hold_grads(_grads_torch(eig_loss(tfit.smallest_right_singular, torch), w * nrm), [want])


# ------------------------------------------------------------ affinities

def test_map_type_and_sym_normalize():
    t = np.arange(10)[None].repeat(2, 0)
    np.testing.assert_array_equal(taff.map_type_gt(_t(t)).numpy(), jaff.map_type_gt(jnp.asarray(t)))
    a = np.random.RandomState(13).rand(2, 16, 16).astype(np.float32)
    a[:, 3, :] = 0.0
    _close(taff._sym_normalize(_t(a)), jaff._sym_normalize(jnp.asarray(a)), **DIST)
    assert taff.PARAM_SLICES == jaff.PARAM_SLICES


@pytest.mark.parametrize("scores", [True, False])
def test_affinity_type(scores):
    rng = np.random.RandomState(14)
    b, n = 2, 64
    xyz = rng.randn(b, n, 3).astype(np.float32)
    params = np.zeros((b, n, 22), np.float32)
    per = _params(rng, b * n)
    for typ, (lo, hi) in jaff.PARAM_SLICES.items():
        params[..., lo:hi] = per[typ].reshape(b, n, hi - lo)
    ids = rng.randint(0, 10, (b, n))
    ids[1, :10] = 1                                 # item 1: an unused type, a full one
    types = np.eye(10, dtype=np.float32)[ids] + 0.1 * rng.rand(b, n, 10).astype(np.float32) \
        if scores else ids
    samples = {2: rng.randn(b, 30, 3).astype(np.float32), 9: rng.randn(b, 30, 3).astype(np.float32)}
    want = _jit(jaff.construction_affinity_matrix_type, min_points=8)(
        xyz, types, params, spline_samples=samples)
    got = taff.construction_affinity_matrix_type(
        _t(xyz), _t(types), _t(params), min_points=8,
        spline_samples={k: _t(v) for k, v in samples.items()})
    _close(got, want, **DIST)
    _close(taff.construction_affinity_matrix_type(_t(xyz), _t(types), _t(params)),
           _jit(jaff.construction_affinity_matrix_type)(xyz, types, params), **DIST)


def test_affinity_normal():
    rng = np.random.RandomState(15)
    xyz = rng.randn(2, 64, 3).astype(np.float32)
    nrm = _unit(rng.randn(2, 64, 3))
    _close(taff.construction_affinity_matrix_normal(_t(xyz), _t(nrm), knn=8),
           _jit(jaff.construction_affinity_matrix_normal, knn=8)(xyz, nrm),
           **DIST)


@pytest.mark.parametrize("n", [32, 256])
def test_compute_entropy(n):
    feat = np.random.RandomState(n).randn(1, n, 16).astype(np.float32)
    _close(taff.compute_entropy(_t(feat)), _jit(jaff.compute_entropy)(feat), **DIST)


# ------------------------------------------------------------ splines

NUMPY_CASES = {
    "bspline_basis_at": (np.random.RandomState(0).rand(40), 12, 3),
    "bspline_basis": (20, 3, 30),
    "uniform_knot_bspline": (10, 8, 2, 3, 16),
    "regular_parameterization": (7, 5),
    "boundary_parameterization": (20,),
    "surface_basis_at": (np.random.RandomState(1).rand(30, 2), 10, 9, 2, 3),
    "_grid_edges": (6, 4),
    "_match_params_to_points": (np.random.RandomState(2).rand(50, 3),
                                np.random.RandomState(3).rand(50, 3)),
    "_resample_to": (np.random.RandomState(4).rand(37, 3), 100, 5),
}


@pytest.mark.parametrize("name", sorted(NUMPY_CASES))
def test_spline_numpy_functions_bit_for_bit(name):
    args = NUMPY_CASES[name]
    got, want = getattr(tspline, name)(*args), getattr(jspline, name)(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _share(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_sample_footpoint_refit():
    rng = np.random.RandomState(9)
    nu, nv = tspline.uniform_knot_bspline(10, 10, 3, 3, 30)
    u, v = np.meshgrid(np.linspace(0, 1, 10), np.linspace(0, 1, 10), indexing="ij")
    cp = np.stack([u, v, 0.3 * np.sin(3 * u) * np.cos(2 * v)], -1)
    cp = np.stack([cp, cp[::-1]]).reshape(2, 100, 3).astype(np.float32)
    surface = tspline.sample_points_from_control_points(nu, nv, _t(cp))
    _close(surface, jspline.sample_points_from_control_points(nu, nv, jnp.asarray(cp)), **DIST)
    surface = surface[0].numpy()
    pts = surface + 0.001 * rng.randn(*surface.shape).astype(np.float32)
    uv = tspline.footpoint_uv(_t(pts), _t(surface), 30)
    want_uv = jspline.footpoint_uv(jnp.asarray(pts), jnp.asarray(surface), 30)
    np.testing.assert_array_equal(uv.numpy(), np.asarray(want_uv))
    _share(tspline.refit_control_points(_t(pts), uv, nu, nv),
           jspline.refit_control_points(jnp.asarray(pts), want_uv, nu, nv))


def test_standardize_points():
    rng = np.random.RandomState(16)
    pts = (rng.randn(2, 80, 3) * [2.0, 1.0, 0.3] + [1.0, -2.0, 0.5]).astype(np.float32)
    w = rng.rand(2, 80, 1).astype(np.float32)
    for weights in (None, w):
        got = tspline.standardize_points(_t(pts), None if weights is None else _t(weights))
        want = _jit(jspline.standardize_points)(pts, weights)
        # each principal axis up to sign: flip the port's rows to JAX's
        sign = np.sign(np.sum(got[3].numpy() * np.asarray(want[3]), -1))       # [B, 3]
        _close(got[0] * _t(sign)[:, None, :], want[0], **FIT)
        _close(got[1], want[1], **FIT)
        _close(got[2], want[2], **FIT)
        _close(got[3] * _t(sign)[:, :, None], want[3], **FIT)


def test_fit_surface_kronecker():
    rng = np.random.RandomState(3)
    u, v = np.meshgrid(np.linspace(0, 1, 10), np.linspace(0, 1, 10), indexing="ij")
    cp_true = np.stack([u, v, 0.2 * u * u - 0.1 * v], -1).reshape(100, 3)
    params = np.concatenate([rng.random_sample((500, 2)),
                             tspline.boundary_parameterization(20)], 0)
    d = tspline.surface_basis_at(params, 10, 10, 2, 2)
    pts = d @ cp_true + 0.002 * rng.randn(len(params), 3)
    _share(tspline.fit_surface_kronecker(_t(pts), _t(d), reg=1e-6),
           jspline.fit_surface_kronecker(pts, d, reg=1e-6))


def test_arap_deform():
    g = 10
    u, v = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g), indexing="ij")
    grid = np.stack([u.ravel(), v.ravel(), np.zeros(g * g)], 1)
    rng = np.random.RandomState(17)
    targets = grid + np.array([0.05, 0.05, 0.1]) + 0.02 * rng.randn(g * g, 3)
    got = tspline.arap_deform(_t(grid), _t(targets), g, g, iters=8, w_fit=0.5)
    _share(got, jspline.arap_deform(grid, targets, g, g, iters=8, w_fit=0.5))


def _open_case():
    rng = np.random.RandomState(1)
    u, v = np.meshgrid(np.linspace(0, 1, 10), np.linspace(0, 1, 10), indexing="ij")
    cp_true = np.stack([u, v, 0.3 * np.sin(2 * u) * np.cos(2 * v)], -1).reshape(100, 3)
    reg40 = jspline.regular_parameterization(40, 40)
    noisy = jspline.surface_basis_at(reg40, 10, 10, 2, 2) @ cp_true
    noisy = noisy + 0.005 * rng.randn(*noisy.shape)
    cp_pred = np.asarray(jspline.fit_surface_kronecker(
        noisy, jspline.surface_basis_at(reg40, 20, 20, 3, 3), reg=1e-4))
    return noisy, cp_pred


def _closed_case():
    rng = np.random.RandomState(2)
    cp = rng.randn(420, 3) * 0.1
    cp[:20] = cp[400:420]
    return rng.randn(500, 3) * 0.1, cp


@pytest.mark.parametrize("case", ["open", "closed", "closed_deform"])
def test_optimize_spline_kronecker(case):
    if case == "open":
        pts, cp = _open_case()
        kw = dict(closed=False, new_cp_size=10, new_degree=2, n_params=1600, out_grid=20)
    else:
        pts, cp = _closed_case()
        kw = dict(closed=True, new_cp_size=8, new_degree=3, deform=case == "closed_deform",
                  n_params=300, out_grid=12)
    got = tspline.optimize_spline_kronecker(pts, cp, device="cpu", **kw)
    want = jspline.optimize_spline_kronecker(pts, cp, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _share(g, w)


def test_optimize_open_close_wrappers(monkeypatch):
    # the wrappers forward to optimize_spline_kronecker with the JAX
    # package's defaults (its cost is held above, at the JAX tests' sizes)
    calls = {}
    for lib in (tspline, jspline):
        monkeypatch.setattr(lib, "optimize_spline_kronecker",
                            lambda *a, _lib=lib, **kw: calls.setdefault(_lib, []).append((a, kw)))
    pts, cp = _closed_case()
    for name in ("optimize_open_spline_kronecker", "optimize_close_spline_kronecker"):
        getattr(tspline, name)(pts, cp, seed=3, device="cpu")
        getattr(jspline, name)(pts, cp, seed=3)
    for (g_args, g_kw), (w_args, w_kw) in zip(calls[tspline], calls[jspline]):
        assert g_args[2:] == w_args[2:] and g_args[0] is pts and g_args[1] is cp
        assert g_kw == dict(w_kw, device="cpu")
